from omega_tpu_torch.stepping.steppers import (
    forward_backward_step,
    make_stepper,
    rk2_step,
    rk4_step,
    run_steps,
)
from omega_tpu_torch.stepping.split import (
    make_split_stepper,
    split_forward_backward_step,
)
