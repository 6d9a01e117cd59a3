from .mesh import BINS, COLUMNS, column_sharding, make_mesh, replicated
from .solve import (initialize_distributed, shard_solver_inputs,
                    solve_ensemble, solve_population)
