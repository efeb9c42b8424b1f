"""Physical constants shared across the model.

Values match the reference (e.g. gravity in ocn/TendencyTerms.h:150-180,
density in configs/Default.yml Tendencies.Density0).
"""

GRAVITY = 9.80665          # gravitational acceleration [m s^-2]
RHO0_SEAWATER = 1026.0     # reference seawater density [kg m^-3]
PI = 3.141592653589793
