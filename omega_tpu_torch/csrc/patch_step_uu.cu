// The sphere's forward-backward step (patch_step.cuh): upwind thickness and
// tracer fluxes.
#include "patch_step.cuh"

OMEGA_PATCH_VARIANTS(uu, true, omega::patch::kTrUpwind)
