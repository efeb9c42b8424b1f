"""omega_tpu_torch — the PyTorch/CUDA port of the omega_tpu ocean dynamical core.

The layered nonlinear shallow-water equations plus tracer
advection-diffusion, discretized with the TRiSK finite-volume scheme
(Thuburn 2009 / Ringler 2010) on MPAS-format Voronoi meshes. The package
mirrors the JAX package's layout (mesh/, ops/, core/, stepping/) so each
module's counterpart is found by path; it imports torch and numpy only.

Plain tensor code is PyTorch; the hot kernels are CUDA C++ under csrc/,
compiled at first use by ops/_build.py:

- the planar hex mesh: the fused forward-backward step (fb_step.cuh,
  fb_step*.cu; with the momentum compiled out, splitpost in split.cu), the
  Runge-Kutta stage (rk_stage.cuh, rk_stage_*.cu) and splitpre's chain
  (split.cu) and the barotropic subcycles (barotropic.cu, all M in one
  cooperative launch), on the compiled entry pattern and slab of
  hex_slab.cuh, the PP81 coefficient
  and column-solve kernels (vmix.cu; the solve's elimination in
  column_solve.cuh), and the structured stencil pass (stencil.cu);
- the icosahedral sphere's patch frames (table layout in
  patch_common.cuh): the forward-backward step (patch_step.cuh,
  patch_step_*.cu, FCT's stage A among them), FCT's limiter (patch_fct.cu),
  the Runge-Kutta stage (patch_rk.cuh, patch_rk_*.cu), the split-explicit
  step (patch_split.cu) with the gather-form barotropic subcycles
  (bt_gather.cu, all M in one cooperative launch; also the composed split
  stepper's on any other mesh), and the PP81 coefficient and column-solve kernels
  (patch_vmix.cu; the solve's elimination in column_solve.cuh, shared
  with the plane);
- unstructured meshes with gather tables (mesh/reorder.py): the weighted
  gather pass (gather.cu).

Devices are explicit: every function that creates tensors takes
`device=None`, meaning `default_device()`, which is the CUDA device and
raises when there is none. Nothing carries on on the CPU because it found
no GPU; callers that want the CPU (the tests) pass device="cpu".
"""

__version__ = "0.1.0"

import torch

from omega_tpu_torch import constants  # noqa: F401


def default_device() -> torch.device:
    """The device entry points use when the caller names none: CUDA.

    Raises RuntimeError when no CUDA device is present."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "omega_tpu_torch needs a CUDA device; none is available "
            "(pass device='cpu' explicitly to run the plain versions)")
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means default_device()."""
    if device is None:
        return default_device()
    return torch.device(device)
