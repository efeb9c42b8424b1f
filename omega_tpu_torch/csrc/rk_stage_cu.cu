// The Runge-Kutta stage kernel (rk_stage.cuh): center thickness flux, upwind tracer flux.
#include "rk_stage.cuh"

OMEGA_RK_VARIANTS(cu, false, true)
