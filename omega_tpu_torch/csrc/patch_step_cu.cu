// The sphere's forward-backward step (patch_step.cuh): center thickness flux,
// upwind tracer flux.
#include "patch_step.cuh"

OMEGA_PATCH_VARIANTS(cu, false, omega::patch::kTrUpwind)
