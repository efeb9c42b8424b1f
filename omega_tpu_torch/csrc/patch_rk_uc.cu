// One RK stage on the sphere (patch_rk.cuh): upwind thickness flux, center
// tracer flux.
#include "patch_rk.cuh"

OMEGA_PATCH_RK_VARIANTS(uc, true, omega::patch::kTrCenter)
