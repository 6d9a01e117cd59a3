from .physics import PhysicsParams
from .solver import (RTConstants, RTResult, SolverConfig, solve_rc,
                     solve_rc_batched)
from .sweeps import absorb_sweep, emit_sweep
