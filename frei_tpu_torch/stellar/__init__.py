from .irradiation import b_star, f_toa, f_toa_np, f_toa_rows
from .phoenix import (bin_spectrum_mean, get_binned_blackbody_spectrum,
                      get_binned_phoenix_spectrum)
