// The sphere's forward-backward step (patch_step.cuh): center thickness and
// tracer fluxes (the flagship chain).
#include "patch_step.cuh"

OMEGA_PATCH_VARIANTS(cc, false, omega::patch::kTrCenter)
