// One RK stage on the sphere (patch_rk.cuh): upwind thickness and tracer
// fluxes.
#include "patch_rk.cuh"

OMEGA_PATCH_RK_VARIANTS(uu, true, omega::patch::kTrUpwind)
