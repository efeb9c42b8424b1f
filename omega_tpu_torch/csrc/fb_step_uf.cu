// The fused forward-backward step (fb_step.cuh): upwind thickness flux, flux-corrected (FCT) tracer flux.
#include "fb_step.cuh"

OMEGA_FB_VARIANTS(uf, true, omega::TR_FCT)
