from omega_tpu_torch.stepping.steppers import (
    forward_backward_step,
    make_stepper,
    run_steps,
)
