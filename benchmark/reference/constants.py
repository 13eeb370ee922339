"""Physical constants, numeric sentinels and solver epsilons.

The port's own copy of the values it needs from
``criteria3d_tpu/constants.py`` (the reference's commonConstants.h and the
solver-local epsilons of water.cpp).
"""

NODATA = -9999.0

# --- physics (commonConstants.h) ---
GRAVITY = 9.80665            # [m s-2]
WATER_DENSITY = 1000.0       # [kg m-3]
ZEROCELSIUS = 273.15         # [K]
R_GAS = 8.31447215           # [J K-1 mol-1]
MH2O = 0.018                 # [kg mol-1] molecular mass of water
VON_KARMAN = 0.41
STEFAN_BOLTZMANN = 5.670373e-8    # [W m-2 K-4]

DAY_SECONDS = 86400.0
HOUR_SECONDS = 3600.0

# --- solver epsilons ---
EPSILON = 1e-5               # commonConstants.h:252
EPSILON_METER = 1e-5         # [m] 10 micrometres (water.cpp:14)
EPSILON_RUNOFF = 1e-3        # [m] 1 mm (commonConstants.h:267)
MIN_INFILTRATION_RATE = 2.78e-11  # [m s-1] = 0.0001 mm/hour (water.cpp:531)
DBL_EPSILON = 2.220446049250313e-16

PI = 3.141592653589793
DEG_TO_RAD = PI / 180.0
RAD_TO_DEG = 180.0 / PI
