// One RK stage on the sphere (patch_rk.cuh): center thickness flux, upwind
// tracer flux.
#include "patch_rk.cuh"

OMEGA_PATCH_RK_VARIANTS(cu, false, omega::patch::kTrUpwind)
