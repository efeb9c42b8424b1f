// The Runge-Kutta stage kernel (rk_stage.cuh): center thickness and tracer fluxes.
#include "rk_stage.cuh"

OMEGA_RK_VARIANTS(cc, false, false)
