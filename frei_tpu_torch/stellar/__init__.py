from .irradiation import b_star, f_toa, f_toa_np
