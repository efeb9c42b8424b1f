// The fused forward-backward step (fb_step.cuh): center thickness flux, upwind tracer flux.
#include "fb_step.cuh"

OMEGA_FB_VARIANTS(cu, false, omega::TR_UPWIND)
