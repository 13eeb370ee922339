"""Numeric sentinels and solver epsilons used by the water path.

The port's own copy of the values it needs from
``criteria3d_tpu/constants.py`` (the reference's commonConstants.h and the
solver-local epsilons of water.cpp).
"""

NODATA = -9999.0

# --- solver epsilons ---
EPSILON = 1e-5               # commonConstants.h:252
EPSILON_METER = 1e-5         # [m] 10 micrometres (water.cpp:14)
EPSILON_RUNOFF = 1e-3        # [m] 1 mm (commonConstants.h:267)
MIN_INFILTRATION_RATE = 2.78e-11  # [m s-1] = 0.0001 mm/hour (water.cpp:531)
DBL_EPSILON = 2.220446049250313e-16

PI = 3.141592653589793
DEG_TO_RAD = PI / 180.0
