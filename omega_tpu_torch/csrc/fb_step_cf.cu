// The fused forward-backward step (fb_step.cuh): center thickness flux, flux-corrected (FCT) tracer flux.
#include "fb_step.cuh"

OMEGA_FB_VARIANTS(cf, false, omega::TR_FCT)
