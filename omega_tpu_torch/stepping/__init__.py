from omega_tpu_torch.stepping.steppers import (
    forward_backward_step,
    make_stepper,
    rk2_step,
    rk4_step,
    run_steps,
)
