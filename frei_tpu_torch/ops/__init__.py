from .planck import bb_flux, planck_lambda
from .twostream import (TwoStreamCouplers, e_correction, propagate_fluxes,
                        two_stream_couplers, two_stream_couplers_g0)
