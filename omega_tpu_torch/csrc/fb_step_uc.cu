// The fused forward-backward step (fb_step.cuh): upwind thickness flux, center tracer flux.
#include "fb_step.cuh"

OMEGA_FB_VARIANTS(uc, true, omega::TR_CENTER)
