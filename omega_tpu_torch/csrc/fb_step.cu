// The fused forward-backward step, center thickness and tracer fluxes (the
// flagship chain), without and with the wind / drag tails; the kernel is the
// template of fb_step.cuh.
#include "fb_step.cuh"

OMEGA_FB_VARIANTS(cc, false, false)

extern "C" {

int omega_fb_params_size_f32() {
  return static_cast<int>(sizeof(omega::FbParams<float>));
}
int omega_fb_params_size_f64() {
  return static_cast<int>(sizeof(omega::FbParams<double>));
}
int omega_fb_slots() { return omega::kFbSlots; }

}  // extern "C"
