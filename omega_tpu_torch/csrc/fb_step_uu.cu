// The fused forward-backward step (fb_step.cuh): upwind thickness and tracer fluxes.
#include "fb_step.cuh"

OMEGA_FB_VARIANTS(uu, true, omega::TR_UPWIND)
