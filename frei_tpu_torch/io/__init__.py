from .convert import (to_layer_tables, to_opacity_stack, to_physics_params,
                      to_resume_state, to_rt_constants)
