"""Parallel layer of the port: the single-device reductions. The
decomposition, halo exchange and sharded steppers of the JAX package's
parallel/ come with the distributed layer (ROADMAP.md queue 1's
`parallel/` item)."""

from omega_tpu_torch.parallel import reductions
from omega_tpu_torch.parallel.reductions import (global_max, global_min,
                                                 global_sum)
