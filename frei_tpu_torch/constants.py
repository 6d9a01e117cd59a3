"""Physical constants in CGS units (copied from ``frei_tpu.constants``).

All device-side arithmetic in frei_tpu_torch is carried out in unitless CGS
floats (cm, g, s, K, erg, barye).  These constants reproduce the values
used by the reference implementation through astropy.constants (CODATA
2018 / IAU 2015), so that numerical parity tests against
``frei`` (which carries astropy Quantities end to end,
e.g. ``frei/twostream.py:1-4``) are exact at the constant level.
"""

# --- exact SI-definition constants, expressed in CGS ---
h = 6.62607015e-27           # Planck constant [erg s]       (exact)
c = 2.99792458e10            # speed of light [cm / s]       (exact)
k_B = 1.380649e-16           # Boltzmann constant [erg / K]  (exact)

# --- measured constants (CODATA 2018, as in astropy 5.x) ---
m_p = 1.67262192369e-24      # proton mass [g]
u_amu = 1.66053906660e-24    # atomic mass unit [g]
G = 6.67430e-8               # gravitational constant [cm^3 / g / s^2]
sigma_sb = 5.6703744191844314e-5   # Stefan-Boltzmann [erg / cm^2 / s / K^4]

# --- astronomical constants (IAU 2015, as in astropy) ---
au = 1.49597870700e13        # astronomical unit [cm]
R_sun = 6.957e10             # solar radius [cm]
M_jup = 1.8981245973360505e30  # Jupiter mass [g]
R_jup = 7.1492e9             # Jupiter equatorial radius [cm]

# Surface gravity of Jupiter, G * M_jup / R_jup**2, as computed by the
# reference (`frei/core.py:99`).
g_jup = G * M_jup / R_jup ** 2   # [cm / s^2] ~ 2478.9

# --- unit conversion factors to CGS ---
BAR_TO_CGS = 1.0e6           # 1 bar = 1e6 barye (dyn / cm^2)
MICRON_TO_CM = 1.0e-4        # 1 um = 1e-4 cm
KM_TO_CM = 1.0e5             # 1 km = 1e5 cm

# h * c / k_B, the Planck exponent scale [cm K]
hc_over_k = h * c / k_B
