// FCT's stage A on the sphere (patch_step.cuh, kind fcta): upwind thickness
// flux, FCT tracer flux.
#include "patch_step.cuh"

OMEGA_PATCH_VARIANTS(uf, true, omega::patch::kTrFct)
