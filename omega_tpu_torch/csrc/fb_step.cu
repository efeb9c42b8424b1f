// The fused forward-backward step, center thickness and tracer fluxes (the
// flagship chain), without and with the wind / drag tails; the kernel is the
// template of fb_step.cuh.
#include "fb_step.cuh"
#include "rk_stage.cuh"

OMEGA_FB_VARIANTS(cc, false, omega::TR_CENTER)

extern "C" {

int omega_fb_params_size_f32() {
  return static_cast<int>(sizeof(omega::FbParams<float>));
}
int omega_fb_params_size_f64() {
  return static_cast<int>(sizeof(omega::FbParams<double>));
}
// slab arrays of a chain: kind 0 = the FB step (fct: its FCT variants),
// 1 = the RK stage
int omega_chain_slots(int kind, int fct) {
  if (kind == 1) return omega::kRkSlots;
  return fct ? omega::fb_slots<omega::TR_FCT>()
             : omega::fb_slots<omega::TR_CENTER>();
}

}  // extern "C"
