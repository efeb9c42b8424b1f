// The Runge-Kutta stage kernel (rk_stage.cuh): upwind thickness flux, center tracer flux.
#include "rk_stage.cuh"

OMEGA_RK_VARIANTS(uc, true, false)
