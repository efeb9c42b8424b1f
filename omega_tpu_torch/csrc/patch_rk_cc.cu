// One RK stage on the sphere (patch_rk.cuh): center thickness and tracer
// fluxes (the flagship chain).
#include "patch_rk.cuh"

OMEGA_PATCH_RK_VARIANTS(cc, false, omega::patch::kTrCenter)
