// The sphere's forward-backward step (patch_step.cuh): upwind thickness flux,
// center tracer flux.
#include "patch_step.cuh"

OMEGA_PATCH_VARIANTS(uc, true, omega::patch::kTrCenter)
