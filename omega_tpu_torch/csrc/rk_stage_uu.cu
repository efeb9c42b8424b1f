// The Runge-Kutta stage kernel (rk_stage.cuh): upwind thickness and tracer fluxes.
#include "rk_stage.cuh"

OMEGA_RK_VARIANTS(uu, true, true)
