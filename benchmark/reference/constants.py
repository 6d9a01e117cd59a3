"""Physical constants in CGS, frozen.

Copied from frei_tpu_torch/constants.py (CODATA 2018 / IAU 2015, the
values the reference frei takes from astropy).  The benchmark's plain
reference reads these, never the program's module.
"""

h = 6.62607015e-27           # Planck constant [erg s]
c = 2.99792458e10            # speed of light [cm / s]
k_B = 1.380649e-16           # Boltzmann constant [erg / K]
m_p = 1.67262192369e-24      # proton mass [g]
u_amu = 1.66053906660e-24    # atomic mass unit [g]
G = 6.67430e-8               # gravitational constant [cm^3 / g / s^2]
sigma_sb = 5.6703744191844314e-5   # Stefan-Boltzmann [erg / cm^2 / s / K^4]
au = 1.49597870700e13        # astronomical unit [cm]
R_sun = 6.957e10             # solar radius [cm]
M_jup = 1.8981245973360505e30  # Jupiter mass [g]
R_jup = 7.1492e9             # Jupiter equatorial radius [cm]
g_jup = G * M_jup / R_jup ** 2   # [cm / s^2], as frei/core.py:99
BAR_TO_CGS = 1.0e6
MICRON_TO_CM = 1.0e-4
hc_over_k = h * c / k_B
