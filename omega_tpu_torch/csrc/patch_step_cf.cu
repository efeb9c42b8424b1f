// FCT's stage A on the sphere (patch_step.cuh, kind fcta): center thickness
// flux, FCT tracer flux.
#include "patch_step.cuh"

OMEGA_PATCH_VARIANTS(cf, false, omega::patch::kTrFct)
