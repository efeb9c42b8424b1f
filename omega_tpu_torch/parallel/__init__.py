"""Parallel layer of the port: the decompositions (general SFC, structured
row/column blocks, patch frames), the halo exchange over a list of shards,
the sharded steppers run by one controller, and the reproducible
reductions, on one array or across shards."""

from omega_tpu_torch.parallel import reductions
from omega_tpu_torch.parallel.decomp import (ShardedMesh, decompose,
                                             partition_cells)
from omega_tpu_torch.parallel.reductions import (global_max, global_min,
                                                 global_sum)
from omega_tpu_torch.parallel.sharded import (build_permute_lists,
                                              default_devices, gather_state,
                                              make_sharded_step, shard_state)
from omega_tpu_torch.parallel import structured_shard  # noqa: E402,F401
