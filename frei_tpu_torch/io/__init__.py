from .cache import (binned_cache_dir, cache_root, grid_fingerprint,
                    load_binned_cache, opacity_store_dir, save_binned_cache)
from .checkpoint import load_solution, resume_state, save_solution
from .convert import (to_layer_tables, to_opacity_stack, to_physics_params,
                      to_resume_state, to_rt_constants, to_rt_result)
