#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (omega_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, as a release check
    python3 chip_smoke.py --profile  # also device time by kernel, every path

It builds the CUDA kernels from omega_tpu_torch/csrc, holds each kernel
against its plain PyTorch version on the card, drives the port's main paths
(256 x 256 cells x 100 layers x 2 tracers, float32; forward-backward, RK2,
RK4 and split-explicit steppers; the icosahedral sphere icos48 x 100 x 2
with the forward-backward, RK4, RK2 and split-explicit steppers, with land
on the patch layout, and its RCM-renumbered gather layout, global and with
land; the sharded runs of parallel/, every shard on this card) through the
entry points a user calls, and prints one JSON line per phase:

  device          the card, and nvidia-smi's name / power-limit line
  build           nvcc build of the kernels, seconds
  kernel_stencil  structured-stencil kernel vs plain, every table (also
                  a 4 x 4 domain and K = 1 at full width); cmean, div and
                  tang timed beside torch.sparse.mm (the stencil as CSR:
                  the library call), with the kernel's registers, spill
                  and blocks per SM
  kernel_fb_step  fused FB step vs plain and vs the composed step, for the
                  flagship chain and its variants (upwind and FCT fluxes,
                  wind, drag), with each variant's registers, spill and
                  blocks per SM; FCT's 0/1 tracer stays in [0, 1]
  kernel_vmix     PP81 coefficient kernel and column-solve kernel vs plain,
                  the solve's registers, spill and blocks per SM
  kernel_rk       RK stage kernel vs plain, every stage mode, with its
                  registers, spill and blocks per SM; fused RK2 / RK4
                  steps vs the composed steppers
  kernel_split    splitpre's passes, the barotropic subcycles (all M in one
                  cooperative launch; M = 1, 7, 10, 30, bt_drag 0 and 1e-4,
                  also float64 at full width) and splitpost vs plain; fused
                  split steps vs the composed split stepper; splitpre's
                  device time per pass (torch.profiler) with its registers,
                  spill and blocks per SM; the subcycle kernel's registers,
                  spill, blocks per SM and grid
  kernel_patch    the sphere's FB step (six launches) vs plain at icos16
                  float64 and icos48 x 100 x 2 float32; fused framed steps
                  vs the composed stepper; each pass's device time
                  (torch.profiler) with its registers, spill and blocks per
                  SM (likewise for the science variant, FCT's stage A and
                  splitpost below); the host parts of a framed step
  kernel_patch_science  the sphere's science variants (upwind fluxes, wind,
                  drag), PP81 coefficient and column-solve kernels vs plain
                  at icos16 float64 and icos48 x 100 x 2 float32; fused
                  science steps vs the composed stepper
  kernel_patch_fct  FCT on the sphere: stage A (the patch step's FCT
                  variant) and stage B (the limiter) vs plain at icos16
                  float64 and icos48 x 100 x 2 float32, center and upwind
                  thickness flux, with and without wind and drag; fused
                  framed FCT steps vs the composed stepper; the kernels'
                  range vs the plain versions' over 10 steps; the FCT fix
                  submesh, its host build and the parts of a step
  kernel_patch_rk  the RK stages on the sphere (five launches per stage)
                  vs plain, every mode, flux pair and tails, at icos16
                  float64 and icos48 x 100 x 2 float32; fused framed RK2 /
                  RK4 steps vs the composed steppers; each mode's time, each
                  pass's device time (torch.profiler) with its registers
                  and spill, the submesh's tendencies and the refresh
  kernel_patch_split  the split-explicit step on the sphere: splitpre (five
                  launches), splitpost (four) and the gather-form barotropic
                  subcycles (one cooperative launch for all M; M = 10,
                  bt_drag 0 and 1e-4 at icos16 float64, M = 1, 7, 10, 30 at
                  icos48 float64 and float32) vs plain at icos16 float64
                  and icos48 x 100 x 2 float32; fused framed split steps vs
                  the composed split stepper; each kernel's time, splitpre's
                  passes' device times with their registers and spill, the
                  subcycle kernel's registers, spill, blocks per SM and
                  grid, the submesh's part, the refresh
  kernel_gather   the gather kernel vs plain on each of the 16 tables of
                  the RCM-renumbered icos48 x 100 float32 with one and two
                  leading indices and icos16 float64, and on a table of 20
                  slots; each case's time (median and spread of 5 x 50
                  launches) beside its bound and torch.sparse.mm's
  main_path       2 x 10 steps of the bench configuration; launch counts
  composed_path   column ssh: the composed stepper + stencil kernel; host
                  and device ms per step, the stencil kernel's share
  science_path    2 x 10 steps with wind, bottom drag, upwind fluxes and PP81
                  vertical mixing: three kernel launches per step
  fct_path        2 x 10 FB steps with FCT tracer fluxes: one launch per step
  rk4_path        2 x 10 RK4 steps of the bench configuration: four launches
  rk2_path        2 x 10 RK2 steps of the science configuration: two stage
                  launches and the two vertical-mixing kernels per step
  split_path      2 x 10 split-explicit steps (column ssh, dt = 120 s, ten
                  barotropic subcycles): 2 + 1 + 1 launches per step
  split_science_path  2 x 10 split-explicit steps of the science
                  configuration with column ssh (upwind fluxes, wind, drag,
                  PP81): composed, its stencil passes through the stencil
                  kernel and one barotropic launch per step, no fused
                  kernel; host and device ms per step, drift, wind, drag
  sphere_path     2 x 10 FB steps of bench.py's sphere (icos48 x 100 x 2):
                  six patch-step launches per step, nothing else
  sphere_science_path  2 x 10 FB steps of the science configuration on the
                  same sphere (upwind fluxes, wind, drag, PP81 mixing): six
                  patch-step launches, one coefficient and one solve launch
                  per step
  sphere_fct_path 2 x 10 FB steps with FCT tracer fluxes on the same sphere
                  (a 0/1 cap, tracer diffusion off): six stage-A and four
                  stage-B launches per step; the cap stays in [0, 1] at the
                  planar FCT limits at u = 0.05 and 0.5 x noise
  sphere_rk4_path 2 x 10 RK4 steps of sphere_path's configuration: four
                  stage calls (4 x 5 launches) per step
  sphere_rk2_path 2 x 10 RK2 steps of sphere_science_path's configuration:
                  two stage calls (2 x 5 launches), one coefficient and one
                  solve launch per step
  sphere_split_composed  2 steps of the composed split stepper on the same
                  sphere with the column free surface, for comparison
  sphere_split_path 2 x 10 split-explicit steps (dt = 120 s, M = 10) of
                  sphere_path's sphere with the column free surface: five
                  splitpre, one subcycle and four splitpost launches per
                  step
  gather_path     2 x 10 FB steps of bench.py's OMEGA_PATCHES=0 sphere
                  (reorder_mesh(spherical_icos_mesh(48)) x 100 x 2): the
                  composed step, every operator with a table one gather
                  launch, no index_select; then the same with the tables
                  stripped (the index_select route)
  coastal_gather_path  the same on a carved icos48 (a continent of about
                  10% of the cells): u = 0 on the coast, the coast's mask
                  kept by reorder_mesh
  gather_split    the gather-form subcycle kernel vs the plain loop on both
                  gather meshes (float64 and float32, M = 1, 7, 10, 30,
                  bt_drag 0 and 1e-4), and one composed split step on each
                  with its subcycles in one bt_gather launch, against the
                  composed step with the plain loop
  rk_order        the manufactured solution in float64: the steppers'
                  temporal order and the spatial order
  driver_path     main_path's configuration through the standalone driver
                  (ocn_init / ocn_run / ocn_finalize, a dict Config): 60
                  steps with and without History / Restart streams, one
                  fb_step launch a step; the state bit for bit run_steps',
                  a restart chain bit for bit the unbroken run; ms a step
                  with and without writes, a history write's seconds
  driver_sphere   the driver with Mesh.Generate PatchLayout: true at icos16
                  x 100 x 2: six patch-step launches a step, the state bit
                  for bit run_steps' on the driver's mesh
  kernel_patch_land  every patch kernel kind on a land-masked sphere
                  (apply_land_mask, land above 55 deg) vs plain: icos16 x 8
                  x 2 float64 (FB, science with PP81, FCT stages A and B,
                  RK mid, splitpre / splitpost, the subcycles), icos48 x 100
                  x 2 float32 (FB, science) by the increment; u = 0 on the
                  masked edges after every launch that writes u
  coastal_patch_path  sphere_path on the patch layout masked by
                  coastal_gather_path's continent: six patch-step launches a
                  step, u = 0 on the masked edges, land unchanged; icos16
                  float64 against carve_mesh's gather layout, 1e-9
  sharded_path    main_path's configuration on the structured decomposition,
                  S = 2 and 4 shards on the card: one fused FB launch a shard
                  a step, owned values against the unsharded run, ms a step,
                  the exchange's share
  sfc_path        the general (SFC) decomposition, 64 x 64 x 20 x 2 float64,
                  S = 4, FB and RK4 against the unsharded run (1e-13), the
                  native partitioner's route
  patch_sharded_path  the patch layout sharded (S = 5 at icos48 float32;
                  S = 2, 5, 10 and the science tails at icos16 float64):
                  six patch-step launches a shard a step, against the
                  single-device framed run
  driver_sharded  driver_path's configuration with Decomp NShards 4
                  (structured, ShardedIO): state and History files equal the
                  unsharded driver's, the restart read shard by shard
                  continues bit for bit
  coupling_path   OmegaComponent on science_path's configuration with wind
                  imports: 3 intervals against one run; S = 4 exports
                  (state kept sharded) against S = 1
  profile         (only with --profile) device time by kernel, every path
  kernels         every kernel: launches, max error, times, bounds

Any failed check raises, so the exit code is non-zero and the closing line
is never printed. Needs a CUDA device; imports nothing of JAX.
"""

import argparse
import dataclasses
import json
import re
import subprocess
import sys
import time

# published peaks of one H100 SXM (dense, 700 W): the yardstick of `bound_ms`
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS_F32 = 67e12

NX = NY = 256
NLAYERS = 100
NTRACERS = 2
DT = 30.0


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    raise RuntimeError(msg)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace a few steps of both paths with "
                    "torch.profiler and print device time by kernel")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    import omega_tpu_torch
    from omega_tpu_torch.core import (ModelConfig, ModelState,
                                      TendencyConfig, VertMixConfig)
    from omega_tpu_torch.mesh import planar_hex_mesh
    from omega_tpu_torch.ops import (_build, megastep, stencil_kernel,
                                     structured, vmix_kernel)
    from omega_tpu_torch.stepping import (forward_backward_step, rk2_step,
                                          rk4_step, run_steps)

    dev = omega_tpu_torch.default_device()
    t_start = time.perf_counter()

    def cuda_ms(fn, reps, warm=2):
        """Mean milliseconds of fn() over `reps` calls, by CUDA events."""
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    def cuda_med(fn, reps=50, repeats=5):
        """The median and spread (min, max) over `repeats` runs of the
        milliseconds per call of fn(), each run `reps` calls between two
        CUDA events: resolves 10% at 0.03 ms per call."""
        runs = sorted(cuda_ms(fn, reps, 2 if i == 0 else 0)
                      for i in range(repeats))
        return {"ms": runs[len(runs) // 2],
                "spread_ms": [runs[0], runs[-1]]}

    def kernel_ms(fn, kernels, reps=20):
        """{label: device milliseconds per call of fn() in the kernels whose
        name holds kernels[label]}, from torch.profiler over `reps` calls
        after an untimed one (None where the trace shows no device time)."""
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = dict.fromkeys(kernels, 0.0)
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                for lab, sub in kernels.items():
                    if sub in e.key:
                        us[lab] += e.device_time_total
        return {lab: t / reps / 1e3 if t > 0 else None
                for lab, t in us.items()}

    def device_ms(fn, steps):
        """Device milliseconds a step of fn(), which runs `steps` steps:
        every kernel and copy torch.profiler records over one call after an
        untimed one, in all and in the stencil kernel ({"all": ms,
        "stencil": ms})."""
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        us = {"all": 0.0, "stencil": 0.0}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                us["all"] += e.device_time_total
                if re.search(r"stencil_(tiled_|direct_)?kernel<", e.key):
                    us["stencil"] += e.device_time_total
        return {k: v / steps / 1e3 for k, v in us.items()}

    def bound(nbytes, flops):
        tb, to = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS_F32 * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    # ---------------------------------------------------------- 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    emit({"phase": "device", "kind": kind,
          "count": torch.cuda.device_count(), "nvidia_smi": smi_line,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # ----------------------------------------------------------- 2. build
    _build.load()
    regs = [ln.strip() for ln in _build.BUILD_INFO["ptxas"].splitlines()
            if "registers" in ln or "spill" in ln.lower()]
    emit({"phase": "build", "seconds": _build.BUILD_INFO["seconds"],
          "cached": _build.BUILD_INFO["cached"],
          "sources": [s.name for s in _build.sources()],
          "ptxas": regs[:64]})

    rng = np.random.default_rng(args.seed)

    def mesh_on_card(nx, ny, dtype):
        return planar_hex_mesh(nx, ny, dc=5000.0, f0=1e-4,
                               bottom_depth=1000.0).to(dev, dtype)

    def rand(shape, dtype):
        return torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                               device=dev)

    # -------------------------------------------------- 3. kernel_stencil
    # f64 at atol 1e-12: sums of at most 8 O(1) products; the kernel may
    # contract a*b+c to one FMA where the plain version rounds twice.
    # f32 at full width: the same, at 1e-5 of the largest output.
    tables = {}
    stencil_err_f32 = 0.0
    # (K = 5, 3 and 1 take the kernel's one-element path, K = 4 and 100
    # its 16-byte path; 4 x 4 is a domain of fewer columns than a block's
    # threads; K = 1 at full width is the column ssh gradient's shape. These two cases draw from a generator of their own, so that
    # the phases after this one keep the inputs they had before them.)
    rng_own = np.random.default_rng(args.seed + 1)
    own_cases = ((4, 4, 3, torch.float64), (NX, NY, 1, torch.float32))
    for (nx, ny, K, dtype, tol) in ((16, 8, 5, torch.float64, 1e-12),
                                    (48, 20, 5, torch.float64, 1e-12),
                                    (24, 12, 4, torch.float64, 1e-12),
                                    (4, 4, 3, torch.float64, 1e-12),
                                    (16, 8, 5, torch.float32, 1e-5),
                                    (NX, NY, 1, torch.float32, 1e-5),
                                    (NX, NY, NLAYERS, torch.float32, 1e-5)):
        mesh = mesh_on_card(nx, ny, dtype)
        keys = [k for k in structured._TABLE_CACHE
                if k[:3] == (nx, ny, mesh.structured_dc)]
        if len(keys) < 22:
            fail(f"only {len(keys)} stencil tables cached at {nx}x{ny}")
        for key in keys:
            tab, dst, src = structured._TABLE_CACHE[key]
            ps, pd = structured._NPER[src], structured._NPER[dst]
            worst = 0.0
            for lead in ((), (2,)):
                f = rand(lead + (ps * nx * ny, K), dtype) \
                    if (nx, ny, K, dtype) not in own_cases else \
                    torch.as_tensor(rng_own.standard_normal(
                        lead + (ps * nx * ny, K)), dtype=dtype, device=dev)
                out = structured.apply_stencil(mesh, (tab, dst, src), f)
                ref = stencil_kernel.apply_stencil_plain(tab, ps, pd, nx, ny,
                                                         f)
                torch.cuda.synchronize()
                if out.shape != ref.shape or not torch.isfinite(out).all():
                    fail(f"stencil {key[3]} {lead}: bad output")
                err = (out - ref).abs().max().item()
                scale = 1.0 if dtype == torch.float64 \
                    else max(ref.abs().max().item(), 1e-30)
                if err > tol * scale:
                    fail(f"stencil {key[3]} lead={lead} at {nx}x{ny}x{K} "
                         f"{dtype}: max error {err} (scale {scale})")
                worst = max(worst, err)
                del f, out, ref
            if dtype == torch.float32 and K == NLAYERS:
                tables[key[3]] = {"max_abs_err": worst}
            if dtype == torch.float32:
                stencil_err_f32 = max(stencil_err_f32, worst)
    # times at the shapes the composed step gives them; the library call
    # is cuSPARSE's SpMM (torch.sparse.mm) with the stencil as a CSR matrix
    # built from the mesh's connectivity (the class-major numbering is the
    # stencil layout), block-diagonal over the leading index
    mesh32 = mesh_on_card(NX, NY, torch.float32)
    C = NX * NY
    host = lambda a: np.asarray(getattr(mesh32, a).cpu())
    csr_of = {"cmean": (host("cells_on_edge"),
                        np.full((3 * C, 2), 0.5), C),
              "div": (host("edges_on_cell"), host("w_div_cell"), 3 * C),
              "tang": (host("edges_on_edge"), host("weights_on_edge"),
                       3 * C)}
    timed = {}
    for name, lead in (("cmean", ()), ("div", ()), ("tang", (2,))):
        tab, dst, src = structured._TABLE_CACHE[
            (NX, NY, mesh32.structured_dc, name)]
        ps, pd = structured._NPER[src], structured._NPER[dst]
        f = rand(lead + (ps * C, NLAYERS), torch.float32)
        nb = 2 if lead else 1
        ms = cuda_ms(lambda: structured.apply_stencil(
            mesh32, (tab, dst, src), f), 20)
        plain = cuda_ms(lambda: stencil_kernel.apply_stencil_plain(
            tab, ps, pd, NX, NY, f), 5)
        A = _spmm_operand(*csr_of[name], nb, dev, torch.float32)
        f2 = f.reshape(-1, NLAYERS)
        lib_err = _spmm_check(
            torch.sparse.mm(A, f2),
            structured.apply_stencil(mesh32, (tab, dst, src), f), name)
        lib_ms = cuda_ms(lambda: torch.sparse.mm(A, f2), 20)
        b_ms, b_by = bound((ps + pd) * nb * C * NLAYERS * 4,
                           2 * len(tab) * nb * C * NLAYERS)
        timed[name] = {"lead": list(lead), "ms": ms, "plain_ms": plain,
                       "library_ms": lib_ms, "library_rel_err": lib_err,
                       "bound_ms": b_ms, "bound_by": b_by,
                       "attrs": stencil_kernel.attrs(torch.float32)}
        tables[name].update(timed[name])
        del f, f2, A
    emit({"phase": "kernel_stencil", "tables": tables,
          "max_abs_err_f32": stencil_err_f32,
          "tolerance": "f64 atol 1e-12; f32 1e-5 of max|ref|"})

    # -------------------------------------------------- 4. kernel_fb_step
    WIND_DRAG = dict(wind_forcing=True, bottom_drag=True,
                     bottom_drag_coeff=3.0e-3)
    UPWIND = dict(flux_thickness_type="upwind", flux_tracer_type="upwind")
    # variant -> (configuration keywords, tendency keywords)
    FB_VARIANTS = {"flagship": ({}, {}),
                   "upwind": (UPWIND, {}),
                   "wind_drag": ({}, WIND_DRAG),
                   "upwind_wind_drag": (UPWIND, WIND_DRAG),
                   "upwind_thickness": (dict(flux_thickness_type="upwind"),
                                        {}),
                   "upwind_tracer": (dict(flux_tracer_type="upwind"),
                                     dict(bottom_drag=True,
                                          bottom_drag_coeff=3.0e-3)),
                   "fct": (dict(flux_tracer_type="fct"), {}),
                   "fct_upwind_wind_drag": (
                       dict(flux_thickness_type="upwind",
                            flux_tracer_type="fct"), WIND_DRAG)}
    FULL_WIDTH = ("flagship", "upwind", "wind_drag", "upwind_wind_drag",
                  "fct", "fct_upwind_wind_drag")

    def bench_cfg(K, L, tend=None, **kw):
        return ModelConfig(nvertlayers=K, ntracers=L,
                           tendencies=TendencyConfig(visc_del2=1.0e3,
                                                     visc_del4=1.0e9,
                                                     **(tend or {})), **kw)

    def put(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    def noisy_state(mesh_np, K, L, dtype):
        kx = 2 * np.pi / mesh_np.x_period
        ky = 2 * np.pi / mesh_np.y_period
        ssh = np.sin(kx * mesh_np.x_cell) * np.sin(ky * mesh_np.y_cell)
        h = (1000.0 + ssh[:, None]) / K * np.ones((1, K))
        return ModelState(
            h=put(h, dtype),
            u=put(0.01 * rng.standard_normal((mesh_np.nedges, K)), dtype),
            tracers=put(10.0 + rng.standard_normal((L, mesh_np.ncells, K)),
                        dtype))

    def step_tracer_state(mesh_np, K, dtype, u_amp):
        """tracer 0 a 0/1 step in x, tracer 1 near 10, random u"""
        kx = 2 * np.pi / mesh_np.x_period
        h = (1000.0 + np.sin(kx * mesh_np.x_cell)[:, None]) / K \
            * np.ones((1, K))
        step = (mesh_np.x_cell > mesh_np.x_period / 2).astype(float)
        tr = np.stack([np.broadcast_to(step[:, None], (mesh_np.ncells, K)),
                       10.0 + rng.standard_normal((mesh_np.ncells, K))])
        return ModelState(
            h=put(h, dtype),
            u=put(u_amp * rng.standard_normal((mesh_np.nedges, K)), dtype),
            tracers=put(tr, dtype))

    def wind_of(mesh_np, dtype):
        """A zonal stress that varies in y and a uniform meridional one."""
        ky = 2 * np.pi / mesh_np.y_period
        return (put(0.1 * np.sin(ky * mesh_np.y_cell), dtype),
                put(0.05 * np.ones(mesh_np.ncells), dtype))

    def nerr(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    def chan_err(got, ref):
        """max over channels of max|got - ref| / max|ref| in the channel"""
        return max(((got[c] - ref[c]).abs().max()
                    / ref[c].abs().max().clamp(min=1e-300)).item()
                   for c in range(ref.shape[0]))

    def incr_err(got, ref, base):
        """per channel: the error of what the launch changed, max|(got -
        in) - (ref - in)|, over the largest change max|ref - in|"""
        return [((got[c] - ref[c]).abs().max()
                 / (ref[c] - base[c]).abs().max().clamp(min=1e-300)).item()
                for c in range(ref.shape[0])]

    fb = {"f64": {}, "tolerance": "f64 rtol=atol=1e-10 over 3 steps, and "
          "after 1 step per channel max|diff| <= 1e-12 max|ref| against "
          "plain; f32 max|diff|/max|ref| <= 1e-4 after 1 step (FMA "
          "contraction and another summation order than the plain "
          "version), and each tracer's error <= 0.05 of the most the step "
          "changed it; against plain, per channel the error of the step's "
          "increment <= FB_INCR of the largest increment"}
    FB_INCR = 0.01
    for (nx, ny, K) in ((32, 16, 3), (48, 20, 5)):
        mesh_np = planar_hex_mesh(nx, ny, dc=5000.0, f0=1e-4,
                                  bottom_depth=1000.0)
        mesh = mesh_np.to(dev, torch.float64)
        wind = wind_of(mesh_np, torch.float64)
        for variant, (kw, tend) in FB_VARIANTS.items():
            cfg = bench_cfg(K, NTRACERS, tend, **kw)
            if not megastep.supported(mesh, cfg):
                fail(f"{variant} configuration not supported by the fused "
                     "kernel")
            st = noisy_state(mesh_np, K, NTRACERS, torch.float64)
            plane = megastep.stack_wind(mesh, cfg, wind, torch.float64)
            ker = pla = megastep.stack_state(mesh, st)
            one = chan_err(megastep.fb_megastep_stacked(mesh, cfg, ker, DT,
                                                        wind=plane),
                           megastep.fb_megastep_plain(mesh, cfg, ker, DT,
                                                      wind=plane))
            if one > 1e-12:
                fail(f"fused FB kernel ({variant}) vs plain at {nx}x{ny}x{K} "
                     f"f64, one step: {one} of max|ref| in a channel")
            comp = st
            for _ in range(3):
                ker = megastep.fb_megastep_stacked(mesh, cfg, ker, DT,
                                                   wind=plane)
                pla = megastep.fb_megastep_plain(mesh, cfg, pla, DT,
                                                 wind=plane)
                comp = _composed_step(mesh, cfg, comp, DT, wind)
            torch.cuda.synchronize()
            comp_s = megastep.stack_state(mesh, comp)
            worst = {}
            for what, ref in (("plain", pla), ("composed", comp_s)):
                d = (ker - ref).abs()
                bad = d > 1e-10 + 1e-10 * ref.abs()
                if bool(bad.any()) or not bool(torch.isfinite(ker).all()):
                    fail(f"fused FB kernel ({variant}) vs {what} at "
                         f"{nx}x{ny}x{K} f64: max abs diff {d.max().item()}")
                worst[what] = d.max().item()
            worst["one_step_channel_err"] = one
            fb["f64"][f"{variant} {nx}x{ny}x{K}"] = worst

    mesh_np = planar_hex_mesh(NX, NY, dc=5000.0, f0=1e-4, bottom_depth=1000.0)
    mesh32 = mesh_np.to(dev, torch.float32)
    wind32 = wind_of(mesh_np, torch.float32)
    st = noisy_state(mesh_np, NLAYERS, NTRACERS, torch.float32)
    s0 = megastep.stack_state(mesh32, st)
    CH = 4 + NTRACERS
    fbv = {}        # per variant: errors, ms, plain ms, bound, plan
    for variant in FULL_WIDTH:
        kw, tend = FB_VARIANTS[variant]
        cfg_v = bench_cfg(NLAYERS, NTRACERS, tend, **kw)
        plane = megastep.stack_wind(mesh32, cfg_v, wind32, torch.float32)
        ker = megastep.fb_megastep_stacked(mesh32, cfg_v, s0, DT, wind=plane)
        pla = megastep.fb_megastep_plain(mesh32, cfg_v, s0, DT, wind=plane)
        comp_s = megastep.stack_state(
            mesh32, _composed_step(mesh32, cfg_v, st, DT, wind32))
        torch.cuda.synchronize()
        if not bool(torch.isfinite(ker).all()):
            fail(f"fused FB kernel ({variant}): non-finite output at full "
                 "width")
        f32 = {}
        for what, ref in (("plain", pla), ("composed", comp_s)):
            errs = {"h": nerr(ker[0], ref[0]), "u": nerr(ker[1:4], ref[1:4]),
                    "tracers": nerr(ker[4:], ref[4:])}
            # a tracer near 10 changes by far less than its value in one
            # step: hold what the step CHANGED, tracer by tracer, to 5% of
            # the largest change (float32 roundoff of the value is 2e-3 of
            # it; a tracer left alone is off by all of it)
            for l in range(NTRACERS):
                moved = (ref[4 + l] - s0[4 + l]).abs().max().item()
                off = (ker[4 + l] - ref[4 + l]).abs().max().item()
                errs[f"tracer{l}_err_over_moved"] = off / max(moved, 1e-30)
                if moved == 0.0 or off > 0.05 * moved:
                    fail(f"fused FB kernel ({variant}) vs {what} at full "
                         f"width f32: tracer {l} moved by {moved}, off by "
                         f"{off}")
            if max(errs["h"], errs["u"], errs["tracers"]) > 1e-4:
                fail(f"fused FB kernel ({variant}) vs {what} at full width "
                     f"f32: {errs}")
            if what == "plain":
                errs["increment"] = incr_err(ker, ref, s0)
                if max(errs["increment"]) > FB_INCR:
                    fail(f"fused FB kernel ({variant}) vs plain at full "
                         f"width f32: increments {errs['increment']}")
            f32[what] = errs
        if plane is not None:
            # the tails reached their layers: against the same step without
            base = megastep.fb_megastep_stacked(
                mesh32, bench_cfg(NLAYERS, NTRACERS, **kw), s0, DT)
            d = (ker - base).abs()
            scale = base[1:4].abs().max().item()
            acted = {"top": d[1:4, 0].max().item() / scale,
                     "bottom": d[1:4, -1].max().item() / scale,
                     "between": d[1:4, 1:-1].max().item() / scale,
                     "h": d[0].max().item()}
            # (another instantiation may contract its FMAs otherwise: the
            # layers between are held to float32 roundoff, not to zero)
            if not (acted["top"] > 1e-4 and acted["bottom"] > 5e-6
                    and acted["between"] <= 1e-6 and acted["h"] == 0):
                fail(f"fused FB kernel ({variant}): wind / drag did not act "
                     f"on the top / bottom layer alone: {acted}")
            f32["tails_moved_u_by"] = acted
            del base, d
        abs_err = (ker - pla).abs().max().item()
        del pla, comp_s
        buf = [s0.clone(), ker]

        def step_pingpong():
            megastep.fb_megastep_stacked(mesh32, cfg_v, buf[0], DT,
                                         out=buf[1], wind=plane)
            buf.reverse()

        ms = cuda_ms(step_pingpong, 20)
        buf[0].copy_(s0)
        plain_ms = cuda_ms(lambda: megastep.fb_megastep_plain(
            mesh32, cfg_v, buf[0], DT, wind=plane), 3, 1)
        tabs, consts = megastep._mega_args(mesh32, cfg_v, DT)
        plan = megastep.hex_plan(4, megastep._ring(tabs, consts, plane),
                                 megastep.slots(consts))
        b_ms, b_by = bound(
            (2 * CH * NLAYERS + (3 if plane is not None else 0)) * C * 4,
            _fb_flops_per_point(tabs, NTRACERS, consts["fct"])
            * NLAYERS * C)
        fbv[variant] = {"f32_256x256x100x2": f32, "max_abs_err": abs_err,
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "plan": plan,
                        "attrs": megastep.fb_step_attrs(
                            cfg_v, torch.float32, plane is not None)}
        del buf, ker
    # FCT is monotone: a 0/1 step tracer stays in [0, 1] over 20 fused
    # steps at full width, with tracer diffusion off, in the reference's
    # flow, u = 0.5 x noise (tests/test_structured.py:577-620). In float64
    # kernel and plain version hold it within 1e-12, as the reference does.
    # In float32 the limiter's bounds come from a field it already rounded,
    # so where it acts at every step an excursion grows by a few ulps a
    # step: each end of the kernel's range may pass the plain version's on
    # the same inputs by at most MONO_ULPS ulps of 1, and the range may pass
    # [0, 1] by at most MONO_F32[u_amp] (set from the readings in PERF.md).
    MONO_ULPS = 4
    MONO_F32 = {0.05: 1e-6, 0.5: 4e-6}
    cfg_mono = bench_cfg(NLAYERS, NTRACERS, dict(eddy_diff2=0.0,
                                                 eddy_diff4=0.0),
                         flux_tracer_type="fct")
    fb["fct_monotone"] = {
        "steps": 20, "tolerance": f"f64: 1e-12; f32: {MONO_F32} by u_amp, "
        f"and at most {MONO_ULPS} ulps of 1 past the plain version's range"}
    mesh64 = mesh_np.to(dev, torch.float64)
    for u_amp, dtype, m in ((0.05, torch.float32, mesh32),
                            (0.5, torch.float32, mesh32),
                            (0.5, torch.float64, mesh64)):
        start = megastep.stack_state(m, step_tracer_state(
            mesh_np, NLAYERS, dtype, u_amp))
        mono = [start.clone(), torch.empty_like(start)]
        pla = start
        for _ in range(20):
            megastep.fb_megastep_stacked(m, cfg_mono, mono[0], DT,
                                         out=mono[1])
            mono.reverse()
            pla = megastep.fb_megastep_plain(m, cfg_mono, pla, DT)
        torch.cuda.synchronize()
        t0 = mono[0][4]
        rec = {"min": t0.min().item(), "max": t0.max().item(),
               "plain_min": pla[4].min().item(),
               "plain_max": pla[4].max().item(),
               "points_strictly_between":
                   ((t0 > 1e-3) & (t0 < 1 - 1e-3)).sum().item()}
        if dtype == torch.float64:
            tol = ulps = 1e-12
        else:
            tol = MONO_F32[u_amp]
            ulps = MONO_ULPS * torch.finfo(dtype).eps
        if not (min(rec["min"], rec["plain_min"]) >= -tol
                and max(rec["max"], rec["plain_max"]) <= 1 + tol
                and rec["min"] >= rec["plain_min"] - ulps
                and rec["max"] <= rec["plain_max"] + ulps
                and rec["points_strictly_between"] > 0):
            fail(f"fused FCT step is not monotone at u = {u_amp} x noise, "
                 f"{dtype}: {rec}")
        fb["fct_monotone"][f"u_amp_{u_amp}_{str(dtype)[6:]}"] = rec
        del mono, t0, start, pla
    del mesh64
    cfg = bench_cfg(NLAYERS, NTRACERS)
    fb.update(fbv["flagship"])
    fb["variants"] = {v: fbv[v] for v in FULL_WIDTH[1:]}
    emit({"phase": "kernel_fb_step", **fb})

    # ----------------------------------------------------- 4b. kernel_vmix
    # f64 at rtol=atol=1e-10 against the plain PCR: the kernel solves the
    # same diagonally dominant system by elimination in chunks (no pivoting
    # needed), so the two differ by the rounding of either, some 1e-15 of
    # a value. f32 at full width: 1e-4 of the largest reference value per
    # output, as for the fused step.
    PP81 = VertMixConfig(enabled=True, scheme="pp81", temp_index=0,
                         salt_index=1)
    CONST = VertMixConfig(enabled=True, kappa_tracer=1.0e-3,
                          kappa_momentum=1.0e-2)

    def stratified_state(mesh_np, K, dtype, u_amp):
        """T decreasing downward, S near 35, sheared u: the Richardson
        number spans stable and unstable interfaces."""
        kx = 2 * np.pi / mesh_np.x_period
        ky = 2 * np.pi / mesh_np.y_period
        ssh = np.sin(kx * mesh_np.x_cell) * np.sin(ky * mesh_np.y_cell)
        h = (1000.0 + ssh[:, None]) / K * np.ones((1, K))
        T = 10.0 + 2.0 * np.arange(K)[::-1] / K \
            + 0.1 * rng.standard_normal((mesh_np.ncells, K))
        S = 35.0 + 0.1 * rng.standard_normal((mesh_np.ncells, K))
        return ModelState(
            h=put(h, dtype),
            u=put(u_amp * rng.standard_normal((mesh_np.nedges, K)), dtype),
            tracers=put(np.stack([T, S]), dtype))

    def column_content(s):
        """sum_k h * tr per column and tracer, in float64."""
        return (s[0].double()[None] * s[4:].double()).sum(1)

    vmx = {"f64": {}, "tolerance": "f64 rtol=atol=1e-10; f32 max|diff| <= "
           "1e-4 max|ref| per output, and per channel the error of the "
           "solve's increment <= 0.05 (science coefficients) / 1e-3 (1 m2/s "
           "coefficients) of the largest increment; column content sum_k "
           "h*tr to 1e-5"}
    for (nx, ny, K) in ((32, 16, 2), (48, 20, 7), (24, 12, 100)):
        mesh_np = planar_hex_mesh(nx, ny, dc=5000.0, f0=1e-4,
                                  bottom_depth=1000.0)
        mesh = mesh_np.to(dev, torch.float64)
        s_in = megastep.stack_state(
            mesh, stratified_state(mesh_np, K, torch.float64, 0.1))
        worst = {}
        for name, vmc in (("constant", CONST), ("pp81", PP81),
                          ("pp81_no_ts", VertMixConfig(
                              enabled=True, scheme="pp81", n_exp=3))):
            cfg_m = bench_cfg(K, NTRACERS, vert_mix=vmc)
            got = vmix_kernel.vmix_stacked(mesh, cfg_m, s_in.clone(), DT)
            ref = vmix_kernel.vmix_plain(mesh, cfg_m, s_in, DT)
            pairs = [("solve", got, ref)]
            if vmc.scheme == "pp81":
                kc, nc = vmix_kernel.pp81_coeffs(mesh, cfg_m, s_in)
                kp, npl = vmix_kernel.pp81_coeffs_plain(mesh, cfg_m, s_in)
                pairs += [("kappa", kc, kp), ("nu", nc, npl)]
            torch.cuda.synchronize()
            for what, a, b in pairs:
                d = (a - b).abs()
                if bool((d > 1e-10 + 1e-10 * b.abs()).any()) \
                        or not bool(torch.isfinite(a).all()):
                    fail(f"vmix kernel {name}/{what} at {nx}x{ny}x{K} f64: "
                         f"max abs diff {d.max().item()}")
                worst[f"{name}/{what}"] = d.max().item()
        vmx["f64"][f"{nx}x{ny}x{K}"] = worst

    # full width, on the state one science step's horizontal kernel leaves
    # (upwind fluxes, wind, drag; no mixing yet). A column solve changes a
    # value by far less than the value, so the solve is held by what it
    # CHANGES, channel by channel: max|(got - in) - (ref - in)| against
    # max|ref - in|. In float32 the solution of a value near 35 carries
    # roundoff of a few 1e-6, up to 1e-2 of an increment of 4e-4: so at the
    # science coefficients each channel's increment is held to 5% (an
    # untouched or wrongly coupled channel is off by the whole of it), and
    # the same kernel is held to 1e-3 of it with coefficients strong enough
    # (1 m2/s) that increments stand clear of roundoff.
    mesh_np = planar_hex_mesh(NX, NY, dc=5000.0, f0=1e-4, bottom_depth=1000.0)
    cfg_pp = bench_cfg(NLAYERS, NTRACERS, WIND_DRAG, vert_mix=PP81, **UPWIND)
    cfg_ct = bench_cfg(NLAYERS, NTRACERS, WIND_DRAG, vert_mix=CONST, **UPWIND)
    STRONG = VertMixConfig(enabled=True, kappa_tracer=1.0, kappa_momentum=1.0)
    STRONG_PP = VertMixConfig(enabled=True, scheme="pp81", temp_index=0,
                              salt_index=1, nu0=1.0, kappa_tracer=0.1,
                              kappa_momentum=0.1)
    cfg_h = bench_cfg(NLAYERS, NTRACERS, WIND_DRAG, **UPWIND)
    sv = megastep.fb_megastep_stacked(
        mesh32, cfg_h, megastep.stack_state(mesh32, stratified_state(
            mesh_np, NLAYERS, torch.float32, 0.05)), DT,
        wind=megastep.stack_wind(mesh32, cfg_h, wind32, torch.float32))
    kap, nu = vmix_kernel.pp81_coeffs(mesh32, cfg_pp, sv)
    kap_p, nu_p = vmix_kernel.pp81_coeffs_plain(mesh32, cfg_pp, sv)
    torch.cuda.synchronize()
    coeff_err = {"kappa": nerr(kap, kap_p), "nu": nerr(nu, nu_p),
                 **{f"nu{i}": nerr(nu[i], nu_p[i]) for i in range(3)}}
    coeff_abs = max((kap - kap_p).abs().max().item(),
                    (nu - nu_p).abs().max().item())
    if max(coeff_err.values()) > 1e-4 or not bool(
            torch.isfinite(kap).all() and torch.isfinite(nu).all()):
        fail(f"PP81 coefficient kernel at full width f32: {coeff_err}")
    spread = (nu.min().item(), nu.max().item())
    if not spread[0] < 0.5 * spread[1]:
        fail(f"PP81 coefficients do not vary: nu in {spread}")
    CHANNELS = ["u0", "u1", "u2"] + [f"tracer{l}" for l in range(NTRACERS)]
    solve = {}
    solve_abs = 0.0
    for name, vmc, limit in (("constant", CONST, 0.05), ("pp81", PP81, 0.05),
                             ("strong_constant", STRONG, 1e-3),
                             ("strong_pp81", STRONG_PP, 1e-3)):
        cfg_m = bench_cfg(NLAYERS, NTRACERS, WIND_DRAG, vert_mix=vmc,
                          **UPWIND)
        coeffs = vmix_kernel.pp81_coeffs(mesh32, cfg_m, sv) \
            if vmc.scheme == "pp81" else None
        got = vmix_kernel.vmix_solve(mesh32, cfg_m, sv.clone(), DT, coeffs)
        ref = vmix_kernel.vmix_solve_plain(mesh32, cfg_m, sv, DT, coeffs)
        torch.cuda.synchronize()
        errs = {"u": nerr(got[1:4], ref[1:4]),
                "tracers": nerr(got[4:], ref[4:]), "increment": {},
                "increment_limit": limit}
        for c, ch in enumerate(CHANNELS, start=1):
            moved = (ref[c] - sv[c]).abs().max().item()
            off = ((got[c] - sv[c]) - (ref[c] - sv[c])).abs().max().item()
            errs["increment"][ch] = {"moved_by": moved,
                                     "err_over_moved": off / max(moved,
                                                                 1e-30)}
        c0, c1 = column_content(sv), column_content(got)
        errs["column_content"] = ((c1 - c0).abs() / c0.abs()).max().item()
        inc = errs["increment"].values()
        if max(errs["u"], errs["tracers"]) > 1e-4 \
                or errs["column_content"] > 1e-5 \
                or not bool(torch.equal(got[0], sv[0])) \
                or any(v["moved_by"] == 0.0 for v in inc) \
                or any(v["err_over_moved"] > limit for v in inc) \
                or not bool(torch.isfinite(got).all()):
            fail(f"vmix solve kernel ({name}) at full width f32: {errs}")
        solve_abs = max(solve_abs, (got - ref).abs().max().item())
        solve[name] = errs
        del got, ref, coeffs
    work = sv.clone()
    coeff_ms = cuda_ms(lambda: vmix_kernel.pp81_coeffs(mesh32, cfg_pp, sv),
                       20)
    coeff_plain_ms = cuda_ms(
        lambda: vmix_kernel.pp81_coeffs_plain(mesh32, cfg_pp, sv), 3, 1)
    solve_ms = {
        "constant": cuda_ms(lambda: vmix_kernel.vmix_solve(
            mesh32, cfg_ct, work, DT), 20),
        "pp81": cuda_ms(lambda: vmix_kernel.vmix_solve(
            mesh32, cfg_pp, work, DT, (kap, nu)), 20)}
    solve_plain_ms = cuda_ms(lambda: vmix_kernel.vmix_solve_plain(
        mesh32, cfg_pp, sv, DT, (kap, nu)), 2, 1)
    KI = NLAYERS - 1
    # reads h, 3 u, T, S; writes kappa and 3 nu; ~90 operations per point
    coeff_b_ms, coeff_b_by = bound((6 * NLAYERS + 4 * KI) * C * 4,
                                   90 * KI * C)
    # reads h, 3 u, L tracers (and the 4 coefficient planes), writes 3 u and
    # L tracers; per row about 12 operations for the coupling and the
    # elimination of the matrix and 7 per right-hand side, in 4 systems
    # with 3 + L right-hand sides in all
    solve_flops = NLAYERS * C * (4 * 12 + 7 * (3 + NTRACERS))
    solve_b = {
        "constant": bound((4 + NTRACERS + 3 + NTRACERS) * NLAYERS * C * 4,
                          solve_flops),
        "pp81": bound(((4 + NTRACERS + 3 + NTRACERS) * NLAYERS + 4 * KI)
                      * C * 4, solve_flops)}
    vmx.update({
        "coeffs": {"f32_256x256x100x2": coeff_err, "max_abs_err": coeff_abs,
                   "nu_range": spread, "ms": coeff_ms,
                   "plain_ms": coeff_plain_ms, "bound_ms": coeff_b_ms,
                   "bound_by": coeff_b_by,
                   "plan": vmix_kernel.plan_coeffs(NY, NX, NLAYERS),
                   "attrs": vmix_kernel.coeff_attrs(torch.float32)},
        "solve": {"f32_256x256x100x2": solve, "max_abs_err": solve_abs,
                  "ms": solve_ms, "plain_ms_pp81": solve_plain_ms,
                  "bound_ms": {k: v[0] for k, v in solve_b.items()},
                  "bound_by": {k: v[1] for k, v in solve_b.items()},
                  "plan": vmix_kernel.plan_chunks(NLAYERS, 4),
                  "attrs": vmix_kernel.solve_attrs(mesh32, cfg_pp, sv)}})
    emit({"phase": "kernel_vmix", **vmx})
    del work, sv, kap_p, nu_p, s0, st

    # ------------------------------------------------------ 4c. kernel_rk
    # every stage mode of the RK stage kernel against rk_stage_plain on the
    # same inputs (the initial state, the provisional state and accumulator
    # the plain first stage makes of it): f64 per channel within 1e-12 of
    # max|ref|; f32 at full width on the increment of every output channel
    # over its input (out over base, or over the accumulator in RK_LAST; the
    # accumulator over its input). Then whole fused RK2 / RK4 steps against
    # the composed steppers in f64.
    RK_INCR = 0.02
    RK_VARIANTS = {"flagship": ({}, {}), "upwind_wind_drag": (UPWIND,
                                                             WIND_DRAG)}
    MODES = {"prov": megastep.RK_PROV, "first": megastep.RK_FIRST,
             "mid": megastep.RK_MID, "last": megastep.RK_LAST}
    CA, CB = 0.5 * DT, DT / 3.0

    def stage_inputs(mesh, cfg, s, plane):
        """(prov, acc) of a plain first stage on stacked state s"""
        acc, prov = megastep.rk_stage_plain(mesh, cfg, megastep.RK_FIRST,
                                            CA, DT / 6.0, s, s, wind=plane)
        return prov, acc

    def stage_call(mesh, cfg, mode, s, prov, acc, plane, out, acc_out):
        """one launch of `mode` on the inputs a step would give it"""
        ev = s if mode in (megastep.RK_PROV, megastep.RK_FIRST) else prov
        megastep.rk_stage(
            mesh, cfg, mode, CA, CB, ev, out,
            base=None if mode == megastep.RK_LAST else s,
            acc=acc if mode in (megastep.RK_MID, megastep.RK_LAST) else None,
            acc_out=acc_out if mode in (megastep.RK_FIRST, megastep.RK_MID)
            else None, wind=plane)

    def stage_check(mesh, cfg, mode, s, prov, acc, plane):
        """(kernel outputs, plain outputs, inputs) of one launch"""
        ev = s if mode in (megastep.RK_PROV, megastep.RK_FIRST) else prov
        ref_acc, ref = megastep.rk_stage_plain(
            mesh, cfg, mode, CA, CB, ev,
            None if mode == megastep.RK_LAST else s,
            acc if mode in (megastep.RK_MID, megastep.RK_LAST) else None,
            wind=plane)
        out = torch.empty_like(s)
        acc_out = acc.clone() if mode == megastep.RK_MID \
            else torch.empty_like(s)       # RK_MID updates acc in place
        stage_call(mesh, cfg, mode, s, prov, acc, plane, out, acc_out)
        # what out's channels are increments of: the state, or in RK_LAST
        # the accumulator's h, u and tracers (tr*h over h)
        pairs = [("out", out, ref, s if mode != megastep.RK_LAST
                  else torch.cat([acc[:4], acc[4:] / acc[0]]))]
        if ref_acc is not None:
            acc_in = acc if mode == megastep.RK_MID else torch.cat(
                [s[:4], s[4:] * s[0]])
            pairs.append(("acc", acc_out, ref_acc, acc_in))
        return pairs

    rk = {"f64": {}, "tolerance": "f64 per channel max|diff| <= 1e-12 "
          "max|ref| (one launch); fused steps vs composed steppers rtol="
          "atol=1e-10 over 2 steps; f32 at full width per output channel "
          "the error of the launch's increment <= RK_INCR of the largest "
          "increment", "RK_INCR": RK_INCR}
    for (nx, ny, K) in ((32, 16, 3), (48, 20, 5)):
        mesh_np = planar_hex_mesh(nx, ny, dc=5000.0, f0=1e-4,
                                  bottom_depth=1000.0)
        mesh = mesh_np.to(dev, torch.float64)
        wind = wind_of(mesh_np, torch.float64)
        for variant, (kw, tend) in RK_VARIANTS.items():
            cfg_r = bench_cfg(K, NTRACERS, tend, **kw)
            for stepper_kind in ("rk2", "rk4"):
                if not megastep.supported(mesh, cfg_r, stepper_kind):
                    fail(f"{variant} not supported by the {stepper_kind} "
                         "stages")
            st = noisy_state(mesh_np, K, NTRACERS, torch.float64)
            s = megastep.stack_state(mesh, st)
            plane = megastep.stack_wind(mesh, cfg_r, wind, torch.float64)
            prov, acc = stage_inputs(mesh, cfg_r, s, plane)
            worst = {}
            for mname, mode in MODES.items():
                for what, got, ref, _ in stage_check(mesh, cfg_r, mode, s,
                                                      prov, acc, plane):
                    e = chan_err(got, ref)
                    worst[f"{mname}/{what}"] = e
                    if e > 1e-12 or not bool(torch.isfinite(got).all()):
                        fail(f"RK stage kernel ({variant}, {mname}) {what} "
                             f"at {nx}x{ny}x{K} f64: {e} of max|ref|")
            # whole steps: the fused path against the composed steppers
            for name, step, fused in (
                    ("rk2", rk2_step, megastep.rk2_megastep_stacked),
                    ("rk4", rk4_step, megastep.rk4_megastep_stacked)):
                comp, ker = st, s
                for _ in range(2):
                    comp = composed(step, mesh, cfg_r, comp, 0.0, DT,
                                    wind_stress=wind)
                    ker = fused(mesh, cfg_r, ker, DT, wind=plane)
                torch.cuda.synchronize()
                ref = megastep.stack_state(mesh, comp)
                d = (ker - ref).abs()
                if bool((d > 1e-10 + 1e-10 * ref.abs()).any()) \
                        or not bool(torch.isfinite(ker).all()):
                    fail(f"fused {name} ({variant}) vs composed at "
                         f"{nx}x{ny}x{K} f64: {d.max().item()}")
                worst[f"{name}_step_vs_composed"] = d.max().item()
            rk["f64"][f"{variant} {nx}x{ny}x{K}"] = worst

    mesh_np = planar_hex_mesh(NX, NY, dc=5000.0, f0=1e-4, bottom_depth=1000.0)
    st = noisy_state(mesh_np, NLAYERS, NTRACERS, torch.float32)
    s0 = megastep.stack_state(mesh32, st)
    V = CH * NLAYERS * C * 4                  # bytes of one stacked state
    rkv = {}
    for variant, (kw, tend) in RK_VARIANTS.items():
        cfg_r = bench_cfg(NLAYERS, NTRACERS, tend, **kw)
        plane = megastep.stack_wind(mesh32, cfg_r, wind32, torch.float32)
        prov, acc = stage_inputs(mesh32, cfg_r, s0, plane)
        tabs, consts = megastep._mega_args(mesh32, cfg_r, DT)
        flops = _fb_flops_per_point(tabs, NTRACERS) * NLAYERS * C
        wbytes = 3 * C * 4 if plane is not None else 0
        res = {"plan": megastep.hex_plan(
            4, megastep._ring(tabs, consts, plane, "rk"), megastep.RK_SLOTS),
            "attrs": megastep.rk_stage_attrs(
                cfg_r, torch.float32,
                plane is not None or consts["cd"] != 0.0), "modes": {}}
        abs_err = 0.0
        for mname, mode in MODES.items():
            errs = {}
            for what, got, ref, base in stage_check(mesh32, cfg_r, mode, s0,
                                                    prov, acc, plane):
                inc = incr_err(got, ref, base)
                errs[what] = {"increment": inc, "value": chan_err(got, ref)}
                if max(inc) > RK_INCR or not bool(torch.isfinite(got).all()):
                    fail(f"RK stage kernel ({variant}, {mname}) {what} at "
                         f"full width f32: increments {inc}")
                abs_err = max(abs_err, (got - ref).abs().max().item())
                del got, ref
            out, acc_out = torch.empty_like(s0), acc.clone()
            ms = cuda_ms(lambda: stage_call(mesh32, cfg_r, mode, s0, prov,
                                            acc, plane, out, acc_out), 20)
            ev = s0 if mode in (megastep.RK_PROV, megastep.RK_FIRST) \
                else prov
            plain_ms = cuda_ms(lambda: megastep.rk_stage_plain(
                mesh32, cfg_r, mode, CA, CB, ev,
                None if mode == megastep.RK_LAST else s0,
                acc if mode in (megastep.RK_MID, megastep.RK_LAST) else None,
                wind=plane), 2, 1)
            # arrays read once and written once: the evaluated level, base
            # and accumulator where the mode reads them (base is the level
            # itself in prov / first), the outputs
            reads = {"prov": 1, "first": 1, "mid": 3, "last": 2}[mname]
            writes = {"prov": 1, "first": 2, "mid": 2, "last": 1}[mname]
            b_ms, b_by = bound((reads + writes) * V + wbytes, flops)
            res["modes"][mname] = {**errs, "ms": ms, "plain_ms": plain_ms,
                                   "bound_ms": b_ms, "bound_by": b_by}
            del out, acc_out
        # the RK2 step's second launch reads a midpoint and the base state
        b2_ms = bound(3 * V + wbytes, flops)[0]
        res.update(max_abs_err=abs_err,
                   rk2_launches_ms=res["modes"]["prov"]["ms"] * 2,
                   rk2_bound_ms=res["modes"]["prov"]["bound_ms"] + b2_ms,
                   rk4_launches_ms=sum(res["modes"][m]["ms"] * n for m, n in (
                       ("first", 1), ("mid", 2), ("last", 1))),
                   rk4_bound_ms=sum(res["modes"][m]["bound_ms"] * n
                                    for m, n in (("first", 1), ("mid", 2),
                                                 ("last", 1))))
        rkv[variant] = res
        del prov, acc
    emit({"phase": "kernel_rk", **rk, "f32_256x256x100x2": rkv})
    del s0, st

    # --------------------------------------------------- 4d. kernel_split
    # the split-explicit kernels (splitpre's three passes, the barotropic
    # subcycles, splitpost) against their plain versions on the same inputs:
    # f64 per channel within 1e-12 of max|ref|, the barotropic kernel (all
    # M subcycles in one cooperative launch) at M = 10, 7, 30, 1 with
    # bt_drag 0 and 1e-4, here and at full width; the fused split step
    # against the composed split stepper on the card, f64, 3 steps, rtol=
    # atol=1e-10 (tests/test_split.py:237-240). f32 at full width: splitpre's
    # outputs (new fields: du_full, the planes) per channel max|diff| over
    # max|ref|; the barotropic kernel's (every case) and splitpost's per
    # channel the error of the increment over the largest increment
    # (ub_final and <ubar> over ubar, ssh over sshc, the state over the
    # state). The limits are about ten times the first run's readings
    # (PERF.md): g_slow 5.1e-6 (a difference of near-equal terms), ssh's
    # increment 3.9e-6, a tracer's increment 5.1e-4 (as in the FB step).
    import port_bounds
    from omega_tpu_torch.ops import barotropic_kernel as btk
    from omega_tpu_torch.stepping import (make_stepper,
                                          split_forward_backward_step)
    DT_SPLIT, M_SPLIT = 120.0, 10
    SPLIT_PRE_ERR, BT_INCR, POST_INCR = 5e-5, 5e-5, 5e-3
    BT_CASES = tuple((M, r) for M in (10, 7, 30, 1) for r in (0.0, 1e-4))
    PRE_NAMES = (["du0", "du1", "du2"]
                 + [f"ubar{t}" for t in range(3)] + ["sshc"]
                 + [f"g_slow{t}" for t in range(3)]
                 + [f"het{t}" for t in range(3)]
                 + [f"du_bar{t}" for t in range(3)])
    BT_NAMES = ["ub0", "ub1", "ub2", "ssh", "uavg0", "uavg1", "uavg2"]

    def pre_pairs(mesh, cfg_s, s, r):
        """(name, kernel, plain) per splitpre output channel, and the plain
        version's du_full and planes"""
        du, planes = megastep.split_work(s)
        megastep.split_pre(mesh, cfg_s, s, du, planes, r)
        du_p, pl_p = megastep.split_pre_plain(mesh, cfg_s, s, r)
        got = list(du) + list(planes[:megastep.P_DUBAR + 3])
        ref = list(du_p) + list(pl_p)
        return list(zip(PRE_NAMES, got, ref)), du_p, pl_p

    def bt_call(mesh, stack, M, r):
        kw = dict(gravity=cfg_s.gravity, dt_bt=DT_SPLIT / M, n_subcycles=M,
                  bt_drag=r)
        return btk.bt_planes(mesh, stack, **kw), btk.bt_plain(mesh, stack,
                                                              **kw)

    def post_inputs(pl_p, bt_ref):
        planes = pl_p.new_zeros((megastep.NPLANES,) + tuple(pl_p.shape[1:]))
        planes[:pl_p.shape[0]] = pl_p
        planes[megastep.P_UBF:megastep.P_UAVG + 3] = bt_ref
        return planes

    spl = {"f64": {}, "tolerance": "f64 per channel max|diff| <= 1e-12 "
           "max|ref|; fused split step vs composed split step rtol=atol="
           "1e-10 over 3 steps; f32 at full width: splitpre per channel "
           "max|diff| <= SPLIT_PRE_ERR max|ref|, barotropic and splitpost "
           "per channel the error of the increment <= BT_INCR / POST_INCR "
           "of the largest increment", "SPLIT_PRE_ERR": SPLIT_PRE_ERR,
           "BT_INCR": BT_INCR, "POST_INCR": POST_INCR}
    for (nx, ny, K) in ((32, 16, 3), (48, 20, 5)):
        mesh_np = planar_hex_mesh(nx, ny, dc=5000.0, f0=1e-4,
                                  bottom_depth=1000.0)
        mesh = mesh_np.to(dev, torch.float64)
        # (tracer hyperdiffusion on, so that every level of splitpost acts)
        cfg_s = bench_cfg(K, NTRACERS, dict(eddy_diff4=1e6),
                          ssh_formulation="column")
        if not megastep.split_supported(mesh, cfg_s):
            fail("split configuration not supported by the split kernels")
        st = noisy_state(mesh_np, K, NTRACERS, torch.float64)
        s = megastep.stack_state(mesh, st)
        worst = {}
        pairs, du_p, pl_p = pre_pairs(mesh, cfg_s, s, 1e-4)
        for name, got, ref in pairs:
            worst[f"pre/{name}"] = chan_err(got[None], ref[None])
        bt_ref10 = None
        for M, r in BT_CASES:
            got, ref = bt_call(mesh, pl_p[:10].contiguous(), M, r)
            worst[f"barotropic M={M} r={r}"] = chan_err(got, ref)
            if M == M_SPLIT and bt_ref10 is None:
                bt_ref10 = ref
        out = torch.empty_like(s)
        planes = post_inputs(pl_p, bt_ref10)
        megastep.split_post(mesh, cfg_s, s, du_p, planes, DT_SPLIT, out)
        worst["post"] = chan_err(out, megastep.split_post_plain(
            mesh, cfg_s, s, du_p, planes, DT_SPLIT))
        torch.cuda.synchronize()
        bad = {k: v for k, v in worst.items() if not v <= 1e-12}
        if bad:
            fail(f"split kernels vs plain at {nx}x{ny}x{K} f64: {bad}")
        # whole steps: the fused path against the composed split stepper
        for M, r in ((M_SPLIT, 0.0), (8, 1e-4)):
            comp, ker = st, s
            for i in range(3):
                comp = composed(split_forward_backward_step, mesh, cfg_s,
                                comp, i * DT_SPLIT, DT_SPLIT, n_subcycles=M,
                                bt_drag=r)
                ker = megastep.split_megastep_stacked(mesh, cfg_s, ker,
                                                      DT_SPLIT, M, r)
            torch.cuda.synchronize()
            ref = megastep.stack_state(mesh, comp)
            d = (ker - ref).abs()
            if bool((d > 1e-10 + 1e-10 * ref.abs()).any()) \
                    or not bool(torch.isfinite(ker).all()):
                fail(f"fused split step (M={M}, r={r}) vs composed at "
                     f"{nx}x{ny}x{K} f64: {d.max().item()}")
            worst[f"step_vs_composed M={M} r={r}"] = d.max().item()
        spl["f64"][f"{nx}x{ny}x{K}"] = worst

    cfg_s = bench_cfg(NLAYERS, NTRACERS, ssh_formulation="column")
    mesh_np = planar_hex_mesh(NX, NY, dc=5000.0, f0=1e-4, bottom_depth=1000.0)
    st = noisy_state(mesh_np, NLAYERS, NTRACERS, torch.float32)
    s0 = megastep.stack_state(mesh32, st)
    f32 = {"pre": {}, "barotropic": {}, "post": {}}
    pairs, du_p, pl_p = pre_pairs(mesh32, cfg_s, s0, 0.0)
    pre_abs = 0.0
    for name, got, ref in pairs:
        e = nerr(got, ref)
        f32["pre"][name] = e
        pre_abs = max(pre_abs, (got - ref).abs().max().item())
        if not e <= SPLIT_PRE_ERR or not bool(torch.isfinite(got).all()):
            fail(f"splitpre {name} at full width f32: {e} of max|ref|")
    stack = pl_p[:10].contiguous()
    base = torch.cat([stack[:4], stack[:3]])
    f32["barotropic_cases"] = {}
    for M, r in BT_CASES:
        got, ref = bt_call(mesh32, stack, M, r)
        inc = incr_err(got, ref, base)
        f32["barotropic_cases"][f"M={M} r={r}"] = max(inc)
        if max(inc) > BT_INCR or not bool(torch.isfinite(got).all()):
            fail(f"barotropic kernel at full width f32, M={M} r={r}: "
                 f"increments {inc}")
    got, bt_ref = bt_call(mesh32, stack, M_SPLIT, 0.0)
    f32["barotropic"] = dict(zip(BT_NAMES, incr_err(got, bt_ref, base)))
    bt_abs = (got - bt_ref).abs().max().item()
    # float64 at full width, every case
    mesh64 = mesh_np.to(dev, torch.float64)
    stack64 = stack.double()
    bt_f64 = {}
    for M, r in BT_CASES:
        got, ref = bt_call(mesh64, stack64, M, r)
        bt_f64[f"M={M} r={r}"] = chan_err(got, ref)
    if not max(bt_f64.values()) <= 1e-12:
        fail(f"barotropic kernel at full width f64: {bt_f64}")
    spl["f64"][f"barotropic_{NX}x{NY}"] = bt_f64
    del mesh64, stack64, got, ref
    planes = post_inputs(pl_p, bt_ref)
    out = torch.empty_like(s0)
    megastep.split_post(mesh32, cfg_s, s0, du_p, planes, DT_SPLIT, out)
    ref = megastep.split_post_plain(mesh32, cfg_s, s0, du_p, planes,
                                    DT_SPLIT)
    torch.cuda.synchronize()
    inc = incr_err(out, ref, s0)
    f32["post"] = dict(zip(["h", "u0", "u1", "u2"]
                           + [f"tracer{l}" for l in range(NTRACERS)], inc))
    post_abs = (out - ref).abs().max().item()
    if max(inc) > POST_INCR or not bool(torch.isfinite(out).all()):
        fail(f"splitpost at full width f32: increments {inc}")
    del ref
    # times at the bench shapes, and the least time of each function
    du, wplanes = megastep.split_work(s0)
    pre_ms = cuda_ms(lambda: megastep.split_pre(mesh32, cfg_s, s0, du,
                                                wplanes), 20)
    pre_plain_ms = cuda_ms(lambda: megastep.split_pre_plain(mesh32, cfg_s,
                                                            s0), 2, 1)
    bt_out = torch.empty((7, NY, NX), dtype=torch.float32, device=dev)
    bt_work = torch.empty((4, NY, NX), dtype=torch.float32, device=dev)
    bt_kw = dict(gravity=cfg_s.gravity, dt_bt=DT_SPLIT / M_SPLIT,
                 n_subcycles=M_SPLIT)
    bt_ms = cuda_ms(lambda: btk.bt_planes(mesh32, stack, out=bt_out,
                                          work=bt_work, **bt_kw), 20)
    # the kernel's own device time (the events above also hold the
    # wrapper's host time where it is the longer)
    bt_dev_ms = kernel_ms(lambda: btk.bt_planes(
        mesh32, stack, out=bt_out, work=bt_work, **bt_kw),
        {"bt": "bt_kernel"})["bt"]
    bt_plain_ms = cuda_ms(lambda: btk.bt_plain(mesh32, stack, **bt_kw), 3, 1)
    post_ms = cuda_ms(lambda: megastep.split_post(
        mesh32, cfg_s, s0, du_p, planes, DT_SPLIT, out), 20)
    post_plain_ms = cuda_ms(lambda: megastep.split_post_plain(
        mesh32, cfg_s, s0, du_p, planes, DT_SPLIT), 2, 1)
    tabs, _ = megastep._mega_args(mesh32, cfg_s, DT_SPLIT)
    pre_f, bt_f, post_f = _split_flops_per_point(tabs, NTRACERS)
    PL = C * 4                                  # bytes of one plane
    VOL = NLAYERS * PL                          # bytes of one volume
    # splitpre reads h and u, writes du_full and 13 planes; the barotropic
    # subcycles read 10 planes and write 7; splitpost reads the state,
    # du_full and 12 planes and writes the state
    pre_b = bound(7 * VOL + 13 * PL, pre_f * NLAYERS * C)
    bt_b = bound(17 * PL, M_SPLIT * bt_f * C)
    post_b = bound((2 * CH + 3) * VOL + 12 * PL, post_f * NLAYERS * C)
    rings = {k: megastep.split_ring(tabs, k)
             for k in megastep._SPLIT_CHAINS}
    # splitpre pass by pass: device time per launch (torch.profiler over
    # whole calls), registers, spill and blocks per SM, each pass's bytes
    pre_attrs = megastep.split_pre_attrs(torch.float32)
    pre_pass_b = port_bounds.split_pre_passes(NX, NY, NLAYERS)
    pre_passes = {
        nm: {"ms": ms, **pre_attrs[nm], "bound_ms": pre_pass_b[nm]["bound_ms"],
             "bound_by": pre_pass_b[nm]["bound_by"]}
        for nm, ms in kernel_ms(
            lambda: megastep.split_pre(mesh32, cfg_s, s0, du, wplanes),
            {nm: f"split_{nm}_kernel"
             for nm in megastep.SPLIT_PRE_PASS_NAMES}).items()}
    rings["barotropic"] = btk.ring(tabs)
    spl["f32_256x256x100x2"] = {
        "errors": f32, "rings": rings,
        "split_pre": {"max_abs_err": pre_abs, "ms": pre_ms,
                      "plain_ms": pre_plain_ms, "bound_ms": pre_b[0],
                      "bound_by": pre_b[1]},
        "split_pre_passes": pre_passes,
        "barotropic": {"M": M_SPLIT, "max_abs_err": bt_abs, "ms": bt_ms,
                       "device_ms": bt_dev_ms,
                       "plain_ms": bt_plain_ms, "bound_ms": bt_b[0],
                       "bound_by": bt_b[1],
                       **btk.attrs(torch.float32, mesh32)},
        "split_post": {"max_abs_err": post_abs, "ms": post_ms,
                       "plain_ms": post_plain_ms, "bound_ms": post_b[0],
                       "bound_by": post_b[1],
                       **megastep.split_post_attrs(torch.float32)}}
    emit({"phase": "kernel_split", **spl})
    splv = spl["f32_256x256x100x2"]
    del s0, st, du, wplanes, du_p, pl_p, planes, out, bt_out, bt_work

    # ---------------------------------------------------- 4e. kernel_patch
    # the sphere's FB step (csrc/patch_step.cuh, six launches per call)
    # against its plain version on the same frames: float64 at icos16 x 8 x
    # 2, per channel max|diff| <= 1e-12 max|ref| (the passes sum the
    # momentum terms in another order than the chain); float32 at bench.py's
    # sphere width (icos48 x 100 x 2) by the increment per channel, limit
    # PATCH_INCR; the fused step against the composed one in float64 over
    # three steps, 1e-10
    from omega_tpu_torch.mesh import patch_icos_mesh, spherical_icos_mesh
    from omega_tpu_torch.ops import bt_gather, patch_megastep

    PATCH_INCR = 5e-4
    N_SPHERE = 48

    def sphere_state(mesh_np, K, L, dtype, u_amp, tr_amp):
        """bench.py's sphere state (h = (depth + sin 2 lat cos lon) / K,
        tracers 10) with u = u_amp x noise x edge_mask and tracer noise"""
        ssh = np.sin(2 * np.asarray(mesh_np.lat_cell)) \
            * np.cos(np.asarray(mesh_np.lon_cell))
        depth = float(np.asarray(mesh_np.bottom_depth)[0])
        h = (depth + ssh[:, None]) / K * np.ones((1, K))
        u = u_amp * rng.standard_normal((mesh_np.nedges, K)) \
            * np.asarray(mesh_np.edge_mask)[:, None]
        tr = 10.0 + tr_amp * rng.standard_normal((L, mesh_np.ncells, K))
        return ModelState(h=put(h, dtype), u=put(u, dtype),
                          tracers=put(tr, dtype))

    # the FB patch step's passes (csrc/patch_step.cuh), and the kernel name
    # each one's device time is read under
    FB_PASS_KERNELS = dict(zip(patch_megastep.FB_PASS_NAMES, (
        "pass_a<", "pass_b<", "pass_c<", "pass_d_cells<", "pass_d_edges<",
        "pass_e<")))

    def fb_passes(fn, cfg_v, tails, bounds=None):
        """{pass: device ms per call of fn() (torch.profiler over whole
        calls), the pass's registers, spill, static shared bytes and blocks
        per SM, and its bound where `bounds` has one}"""
        attrs = patch_megastep.fb_pass_attrs(cfg_v, torch.float32, tails)
        times = kernel_ms(fn, FB_PASS_KERNELS)
        return {nm: {"ms": ms, **attrs[nm],
                     **({"bound_ms": bounds[nm]["bound_ms"]}
                        if bounds else {})}
                for nm, ms in times.items()}

    pat = {"tolerance": "f64 per channel max|diff| <= 1e-12 max|ref| "
           "against plain; fused framed steps vs composed steps rtol=atol="
           "1e-10 over 3 steps; f32 per channel the error of the increment "
           "<= PATCH_INCR of the largest increment", "PATCH_INCR": PATCH_INCR,
           "passes_per_step": patch_megastep.PASSES,
           "threads": patch_megastep.THREADS}
    t_m = time.perf_counter()
    m16_np = patch_icos_mesh(spherical_icos_mesh(16), 16)
    m16 = m16_np.to(dev, torch.float64)
    cfg16 = bench_cfg(8, NTRACERS, dict(eddy_diff4=1e9))
    if not patch_megastep.supported(m16, cfg16):
        fail("flagship sphere configuration not supported by the patch step")
    st16 = sphere_state(m16_np, 8, NTRACERS, torch.float64, 0.1, 1.0)
    p16 = patch_megastep.prep(m16, torch.float64, dev)
    pat["icos16_host_build_s"] = time.perf_counter() - t_m
    fr16, _ = patch_megastep.stack_frames(m16, cfg16, st16)
    got = patch_megastep.chain(p16, cfg16, fr16, DT)
    ref = patch_megastep.chain_plain(p16, cfg16, fr16, DT)
    torch.cuda.synchronize()
    names = ["h", "u0", "u1", "u2"] + [f"tracer{l}" for l in range(NTRACERS)]
    errs = {n_: chan_err(got[:, c][None], ref[:, c][None])
            for c, n_ in enumerate(names)}
    if not all(e <= 1e-12 for e in errs.values()) \
            or not bool(torch.isfinite(got).all()):
        fail(f"patch step vs plain at icos16 f64: {errs}")
    pat["f64_icos16x8x2"] = errs
    # whole steps: the framed fused path against the composed stepper
    patch_megastep.launches = 0
    ker = run_steps(m16, cfg16, st16, 0.0, DT, 3)
    if patch_megastep.launches != 3 * patch_megastep.PASSES:
        fail(f"fused sphere steps: {patch_megastep.launches} launches in 3")
    comp = st16
    for i in range(3):
        comp = composed(forward_backward_step, m16, cfg16, comp, i * DT, DT)
    torch.cuda.synchronize()
    worst = 0.0
    for a_, b_ in zip(ker, comp):
        d = (a_ - b_).abs()
        if bool((d > 1e-10 + 1e-10 * b_.abs()).any()) \
                or not bool(torch.isfinite(a_).all()):
            fail(f"fused sphere steps vs composed at icos16 f64: "
                 f"{d.max().item()}")
        worst = max(worst, d.max().item())
    pat["f64_icos16_steps_vs_composed"] = worst
    del fr16, got, ref, ker, comp

    # float32 at full width: bench.py's sphere mesh, built on the host
    t_m = time.perf_counter()
    m48_np = patch_icos_mesh(spherical_icos_mesh(N_SPHERE), N_SPHERE)
    m48 = m48_np.to(dev, torch.float32)
    p48 = patch_megastep.prep(m48, torch.float32, dev)
    sphere_build_s = time.perf_counter() - t_m
    cfg48 = bench_cfg(NLAYERS, NTRACERS)
    st48 = sphere_state(m48_np, NLAYERS, NTRACERS, torch.float32, 0.01, 1.0)
    fr48, fix48 = patch_megastep.stack_frames(m48, cfg48, st48)
    out48 = torch.empty_like(fr48)
    work48 = patch_megastep.new_work(fr48)
    patch_megastep.chain(p48, cfg48, fr48, DT, out48, work48)
    ref = patch_megastep.chain_plain(p48, cfg48, fr48, DT)
    torch.cuda.synchronize()
    inc = incr_err(out48.transpose(0, 1), ref.transpose(0, 1),
                   fr48.transpose(0, 1))
    patch_abs = (out48 - ref).abs().max().item()
    if max(inc) > PATCH_INCR or not bool(torch.isfinite(out48).all()):
        fail(f"patch step at icos{N_SPHERE} f32: increments "
             f"{dict(zip(names, inc))}")
    del ref
    patch_ms = cuda_ms(lambda: patch_megastep.chain(
        p48, cfg48, fr48, DT, out48, work48), 20)
    patch_plain_ms = cuda_ms(lambda: patch_megastep.chain_plain(
        p48, cfg48, fr48, DT), 2, 1)
    passes_ms = fb_passes(lambda: patch_megastep.chain(
        p48, cfg48, fr48, DT, out48, work48), cfg48, False,
        port_bounds.patch_fb_passes(N_SPHERE))
    # the host parts of a framed step: the pole submesh's composed step and
    # the in-frame refresh (on a copy of the chain's output)
    sub48 = patch_megastep._sub_state(p48, fr48, fix48)
    sub_ms = cuda_ms(lambda: forward_backward_step(p48.sub_mesh, cfg48,
                                                   sub48, 0.0, DT), 20)
    nfix48 = dict(h=sub48.h[p48.fix_cells_local],
                  u=sub48.u[p48.fix_edges_local],
                  tr=sub48.tracers[:, p48.fix_cells_local])
    scratch48 = out48.clone()
    refresh_ms = cuda_ms(lambda: patch_megastep._refresh_frames(
        p48, scratch48, nfix48, p48.persist), 20)
    del scratch48
    if port_bounds.K != NLAYERS or port_bounds.L != NTRACERS:
        fail("port_bounds counts another width than this run")
    pb = port_bounds.patch_fb(N_SPHERE)
    pat[f"f32_icos{N_SPHERE}x{NLAYERS}x{NTRACERS}"] = {
        "increments": dict(zip(names, inc)), "max_abs_err": patch_abs,
        "ms": patch_ms, "plain_ms": patch_plain_ms,
        "bound_ms": pb["bound_ms"], "bound_by": pb["bound_by"],
        "bound_bytes": pb["bytes"], "frames": list(fr48.shape),
        "positions": p48.P, "submesh_cells": int(p48.sub_cells.numel()),
        "fix_cells": int(p48.fix_cells_global.numel()),
        "fix_edges": int(p48.fix_edges_global.numel()),
        "submesh_step_ms": sub_ms, "refresh_ms": refresh_ms,
        "host_build_s": sphere_build_s, "passes": passes_ms}
    emit({"phase": "kernel_patch", **pat})
    patv = pat[f"f32_icos{N_SPHERE}x{NLAYERS}x{NTRACERS}"]
    del fr48, out48, work48, sub48

    # ------------------------------------------- 4f. kernel_patch_science
    # the sphere's science variants against their plain versions on the
    # same inputs: the patch step with upwind fluxes and the wind / drag
    # tails (csrc/patch_step.cuh), the PP81 coefficient kernel and the
    # column solve (csrc/patch_vmix.cu), PP81 and constant coefficients,
    # upwind and center fluxes. Float64 at icos16 x 8 x 2: per channel
    # max|diff| <= 1e-12 max|ref| (coefficients over the interfaces, NaN
    # where the plain version has NaN: lattice holes); three fused framed
    # steps against the composed stepper, 1e-10. Float32 at icos48 x 100 x
    # 2: the patch step by the increment per channel (SCI_INCR), the
    # coefficients by max|diff| / max|ref| (SCI_COEF); the solve at the
    # science coefficients by max|diff| / max|ref| per channel (SCI_SOLVE:
    # with 40 m layers a step changes T and S by about 1e-5, of the order
    # of their float32 roundoff, so its increments are recorded, not held),
    # and at coefficients of 1 m2/s, whose increments stand clear of the
    # roundoff, by what it changes per channel (SCI_SOLVE_STRONG). The
    # limits are ten times the first readings on the card (PERF.md)
    SCI_INCR, SCI_COEF, SCI_SOLVE, SCI_SOLVE_STRONG = 2.6e-4, 9.4e-7, \
        1.1e-6, 5.3e-3
    SCI_WIND_DRAG = dict(wind_forcing=True, bottom_drag=True,
                         bottom_drag_coeff=3.0e-3)
    # variant -> (configuration keywords, tendency keywords)
    SCI_VARIANTS = {
        "upwind_wind_drag_pp81": (dict(vert_mix=PP81, **UPWIND),
                                  SCI_WIND_DRAG),
        "center_wind_drag_constant": (dict(vert_mix=CONST), SCI_WIND_DRAG),
        "upwind_thickness_drag_pp81": (
            dict(vert_mix=PP81, flux_thickness_type="upwind"),
            dict(bottom_drag=True, bottom_drag_coeff=3.0e-3)),
        "upwind_tracer_wind_constant": (
            dict(vert_mix=CONST, flux_tracer_type="upwind"),
            dict(wind_forcing=True))}
    SCI_CHANNELS = names

    def sphere_strat(mesh_np, K, dtype, u_amp):
        """The sphere's h of sphere_state, u = u_amp x noise x edge_mask,
        stratified T (decreasing downward, plus noise) and S near 35"""
        st = sphere_state(mesh_np, K, NTRACERS, dtype, u_amp, 0.0)
        T = 10.0 + 2.0 * np.arange(K)[::-1] / K \
            + 0.1 * rng.standard_normal((mesh_np.ncells, K))
        S = 35.0 + 0.1 * rng.standard_normal((mesh_np.ncells, K))
        return ModelState(h=st.h, u=st.u,
                          tracers=put(np.stack([T, S]), dtype))

    def sphere_wind(mesh_np, dtype):
        """zonal and meridional stress varying with latitude
        (tests/test_patches.py:295-296)"""
        lat = np.asarray(mesh_np.lat_cell)
        return (put(0.1 * np.cos(lat), dtype), put(0.05 * np.sin(lat), dtype))

    def nan_err(got, ref):
        """per channel max|diff| / max|ref| over the finite values of ref;
        inf when the two have NaN in other places"""
        out = []
        for c in range(ref.shape[1]):
            a, b = got[:, c], ref[:, c]
            if not bool(torch.equal(torch.isnan(a), torch.isnan(b))):
                out.append(float("inf"))
                continue
            fin = torch.isfinite(b)
            out.append(((a - b).abs()[fin].max()
                        / b.abs()[fin].max().clamp(min=1e-300)).item())
        return out

    sci = {"tolerance": "f64 per channel max|diff| <= 1e-12 max|ref| "
           "against plain (coefficients over the finite values, NaN in the "
           "same places), fused framed steps vs composed steps rtol=atol="
           "1e-10 over 3 steps; f32 per channel: the patch step's increment "
           "<= SCI_INCR of the largest increment, the coefficients' error "
           "<= SCI_COEF of max|ref|, the solve's error <= SCI_SOLVE of "
           "max|ref| at the science coefficients and its increment <= "
           "SCI_SOLVE_STRONG of the largest increment at 1 m2/s",
           "SCI_INCR": SCI_INCR, "SCI_COEF": SCI_COEF,
           "SCI_SOLVE": SCI_SOLVE, "SCI_SOLVE_STRONG": SCI_SOLVE_STRONG,
           "f64_icos16x8x2": {}}
    w16 = sphere_wind(m16_np, torch.float64)
    st16s = sphere_strat(m16_np, 8, torch.float64, 0.1)
    for variant, (kw, tend) in SCI_VARIANTS.items():
        cfg_v = bench_cfg(8, NTRACERS, tend, **kw)
        if not patch_megastep.supported(m16, cfg_v):
            fail(f"sphere {variant} not supported by the fused path")
        fr16, _ = patch_megastep.stack_frames(m16, cfg_v, st16s)
        pw16 = patch_megastep.make_wind(m16, cfg_v, w16, torch.float64)
        got = patch_megastep.chain(p16, cfg_v, fr16, DT, wind=pw16)
        hz = patch_megastep.chain_plain(p16, cfg_v, fr16, DT, wind=pw16)
        torch.cuda.synchronize()
        errs = {"step": dict(zip(SCI_CHANNELS, [
            chan_err(got[:, c][None], hz[:, c][None])
            for c in range(len(SCI_CHANNELS))]))}
        coef = None
        if cfg_v.vert_mix.scheme == "pp81":
            coef = patch_megastep.vmix_coeffs_plain(p16, cfg_v, hz)
            kc = patch_megastep.vmix_coeffs(p16, cfg_v, hz)
            torch.cuda.synchronize()
            errs["coeffs"] = dict(zip(["kappa", "nu0", "nu1", "nu2"],
                                      nan_err(kc[:-1], coef[:-1])))
        sv = patch_megastep.vmix_solve(p16, cfg_v, hz.clone(), DT, coef)
        sp = patch_megastep.vmix_solve_plain(p16, cfg_v, hz, DT, coef)
        torch.cuda.synchronize()
        errs["solve"] = dict(zip(SCI_CHANNELS, [
            chan_err(sv[:, c][None], sp[:, c][None])
            for c in range(len(SCI_CHANNELS))]))
        worst = max(v for e in errs.values() for v in e.values())
        if not worst <= 1e-12 or not bool(torch.isfinite(got).all()) \
                or not bool(torch.isfinite(sv).all()) \
                or (sv - hz).abs().max().item() == 0.0:
            fail(f"sphere {variant} kernels vs plain at icos16 f64: {errs}")
        sci["f64_icos16x8x2"][variant] = errs
    # whole steps: the framed fused path against the composed stepper
    cfg16s = bench_cfg(8, NTRACERS, SCI_WIND_DRAG, vert_mix=PP81, **UPWIND)
    patch_megastep.launches = patch_megastep.coeff_launches = 0
    patch_megastep.solve_launches = 0
    ker = run_steps(m16, cfg16s, st16s, 0.0, DT, 3, wind_stress=w16)
    got_l = (patch_megastep.launches, patch_megastep.coeff_launches,
             patch_megastep.solve_launches)
    if got_l != (3 * patch_megastep.PASSES, 3, 3):
        fail(f"fused science sphere steps: launches {got_l} in 3")
    comp = st16s
    for i in range(3):
        comp = composed(forward_backward_step, m16, cfg16s, comp, i * DT, DT,
                        wind_stress=w16)
    torch.cuda.synchronize()
    worst = 0.0
    for a_, b_ in zip(ker, comp):
        d = (a_ - b_).abs()
        if bool((d > 1e-10 + 1e-10 * b_.abs()).any()) \
                or not bool(torch.isfinite(a_).all()):
            fail(f"fused science sphere steps vs composed at icos16 f64: "
                 f"{d.max().item()}")
        worst = max(worst, d.max().item())
    sci["f64_icos16_steps_vs_composed"] = worst
    del fr16, got, hz, sv, sp, ker, comp

    # float32 at bench.py's sphere width, on the science state
    cfg48s = bench_cfg(NLAYERS, NTRACERS, SCI_WIND_DRAG, vert_mix=PP81,
                       **UPWIND)
    cfg48c = bench_cfg(NLAYERS, NTRACERS, SCI_WIND_DRAG, vert_mix=CONST)
    w48 = sphere_wind(m48_np, torch.float32)
    st48s = sphere_strat(m48_np, NLAYERS, torch.float32, 0.01)
    fr48, _ = patch_megastep.stack_frames(m48, cfg48s, st48s)
    out48 = torch.empty_like(fr48)
    work48 = patch_megastep.new_work(fr48)
    coef48 = patch_megastep.new_coef(fr48, cfg48s)
    f32 = {}
    for variant, cfg_v in (("upwind_wind_drag_pp81", cfg48s),
                           ("center_wind_drag_constant", cfg48c)):
        pw48 = patch_megastep.make_wind(m48, cfg_v, w48, torch.float32)
        patch_megastep.chain(p48, cfg_v, fr48, DT, out48, work48, pw48)
        hz = patch_megastep.chain_plain(p48, cfg_v, fr48, DT, wind=pw48)
        torch.cuda.synchronize()
        inc = incr_err(out48.transpose(0, 1), hz.transpose(0, 1),
                       fr48.transpose(0, 1))
        res = {"step_increments": dict(zip(SCI_CHANNELS, inc)),
               "step_max_abs_err": (out48 - hz).abs().max().item()}
        coef = None
        if cfg_v.vert_mix.scheme == "pp81":
            coef = patch_megastep.vmix_coeffs_plain(p48, cfg_v, hz)
            coef48 = patch_megastep.vmix_coeffs(p48, cfg_v, hz, coef48)
            torch.cuda.synchronize()
            ce = nan_err(coef48[:-1], coef[:-1])
            fin = torch.isfinite(coef[:-1])
            res["coeffs"] = dict(zip(["kappa", "nu0", "nu1", "nu2"], ce))
            res["coeffs_max_abs_err"] = \
                (coef48[:-1] - coef[:-1]).abs()[fin].max().item()
            spread = (coef[:-1, 1:][fin[:, 1:]].min().item(),
                      coef[:-1, 1:][fin[:, 1:]].max().item())
            res["nu_range"] = spread
            if max(ce) > SCI_COEF or not spread[0] < 0.5 * spread[1]:
                fail(f"sphere PP81 coefficients at icos{N_SPHERE} f32: "
                     f"{res}")
        if max(inc) > SCI_INCR or not bool(torch.isfinite(out48).all()):
            fail(f"sphere {variant} patch step at icos{N_SPHERE} f32: {res}")
        solves = [(variant, cfg_v, coef, None)]
        if cfg_v.vert_mix.scheme == "pp81":
            cfg_sp = bench_cfg(NLAYERS, NTRACERS, SCI_WIND_DRAG,
                               vert_mix=STRONG_PP, **UPWIND)
            solves += [
                ("strong_constant", bench_cfg(NLAYERS, NTRACERS,
                                              vert_mix=STRONG), None,
                 SCI_SOLVE_STRONG),
                ("strong_pp81", cfg_sp, patch_megastep.vmix_coeffs_plain(
                    p48, cfg_sp, hz), SCI_SOLVE_STRONG)]
        for name_s, cfg_s, coef_s, inc_limit in solves:
            sv = patch_megastep.vmix_solve(p48, cfg_s, hz.clone(), DT, coef_s)
            sp = patch_megastep.vmix_solve_plain(p48, cfg_s, hz, DT, coef_s)
            torch.cuda.synchronize()
            sinc = incr_err(sv[:, 1:].transpose(0, 1),
                            sp[:, 1:].transpose(0, 1),
                            hz[:, 1:].transpose(0, 1))
            moved = [(sp[:, c] - hz[:, c]).abs().max().item()
                     for c in range(1, len(SCI_CHANNELS))]
            rel = [chan_err(sv[:, c][None], sp[:, c][None])
                   for c in range(1, len(SCI_CHANNELS))]
            sres = {"increments": dict(zip(SCI_CHANNELS[1:], sinc)),
                    "moved_by": dict(zip(SCI_CHANNELS[1:], moved)),
                    "increment_limit": inc_limit,
                    "errors": dict(zip(SCI_CHANNELS[1:], rel)),
                    "max_abs_err": (sv - sp).abs().max().item()}
            if (max(sinc) > inc_limit if inc_limit else max(rel) > SCI_SOLVE) \
                    or min(moved) == 0.0 \
                    or not bool(torch.equal(sv[:, 0], hz[:, 0])) \
                    or not bool(torch.isfinite(sv).all()):
                fail(f"sphere solve ({name_s}) at icos{N_SPHERE} f32: "
                     f"{sres}")
            res[f"solve_{name_s}"] = sres
            del sv, sp
        f32[variant] = res
        del hz
    # times at the path's shapes (the science variant on the frames the
    # path carries; the solve in place on the step's output)
    pw48 = patch_megastep.make_wind(m48, cfg48s, w48, torch.float32)
    sci_step_ms = cuda_ms(lambda: patch_megastep.chain(
        p48, cfg48s, fr48, DT, out48, work48, pw48), 20)
    sci_step_plain_ms = cuda_ms(lambda: patch_megastep.chain_plain(
        p48, cfg48s, fr48, DT, wind=pw48), 2, 1)
    sci_passes = fb_passes(lambda: patch_megastep.chain(
        p48, cfg48s, fr48, DT, out48, work48, pw48), cfg48s, True)
    sci_coef_ms = cuda_ms(lambda: patch_megastep.vmix_coeffs(
        p48, cfg48s, out48, coef48), 20)
    sci_coef_plain_ms = cuda_ms(lambda: patch_megastep.vmix_coeffs_plain(
        p48, cfg48s, out48), 2, 1)
    scratch48 = out48.clone()
    sci_solve_ms = {
        "pp81": cuda_ms(lambda: patch_megastep.vmix_solve(
            p48, cfg48s, scratch48, DT, coef48), 20),
        "constant": cuda_ms(lambda: patch_megastep.vmix_solve(
            p48, cfg48c, scratch48, DT), 20)}
    sci_solve_plain_ms = cuda_ms(lambda: patch_megastep.vmix_solve_plain(
        p48, cfg48s, out48, DT, coef48), 2, 1)
    # the host parts of a science step: the pole submesh's composed step
    # with wind, drag and PP81, and the refresh
    sub48 = patch_megastep._sub_state(p48, fr48, patch_megastep.stack_frames(
        m48, cfg48s, st48s)[1])
    sci_sub_ms = cuda_ms(lambda: forward_backward_step(
        p48.sub_mesh, cfg48s, sub48, 0.0, DT, wind_stress=pw48[1]), 20)
    nfix48 = dict(h=sub48.h[p48.fix_cells_local],
                  u=sub48.u[p48.fix_edges_local],
                  tr=sub48.tracers[:, p48.fix_cells_local])
    sci_refresh_ms = cuda_ms(lambda: patch_megastep._refresh_frames(
        p48, scratch48, nfix48, p48.persist), 20)
    psb = port_bounds.patch_science(N_SPHERE)
    f32.update({
        "step_ms": sci_step_ms, "step_plain_ms": sci_step_plain_ms,
        "step_passes": sci_passes,
        "coeffs_ms": sci_coef_ms, "coeffs_plain_ms": sci_coef_plain_ms,
        "solve_ms": sci_solve_ms, "solve_plain_ms_pp81": sci_solve_plain_ms,
        "submesh_step_ms": sci_sub_ms, "refresh_ms": sci_refresh_ms,
        "bound_ms": {k: v["bound_ms"] for k, v in psb["parts"].items()},
        "bound_by": {k: v["bound_by"] for k, v in psb["parts"].items()},
        "step_bound_ms": psb["bound_ms"],
        "coeffs_attrs": patch_megastep.coeff_attrs(cfg48s, scratch48),
        "solve_attrs": patch_megastep.solve_attrs(cfg48s, scratch48)})
    sci[f"f32_icos{N_SPHERE}x{NLAYERS}x{NTRACERS}"] = f32
    emit({"phase": "kernel_patch_science", **sci})
    sciv = f32
    del fr48, out48, work48, coef48, scratch48, sub48

    # ----------------------------------------------- 4g. kernel_patch_fct
    # Zalesak FCT on the sphere: stage A (the patch step's FCT variant,
    # csrc/patch_step_cf.cu / _uf.cu, six launches per call) and stage B
    # (the limiter, csrc/patch_fct.cu, four launches per call) against their
    # plain versions on the same inputs (stage B on stage A's output after
    # the refresh the driver makes), center and upwind thickness flux, with
    # and without wind and drag. Float64 at icos16 x 8 x 2: per channel
    # max|diff| <= 1e-14 max|ref|; three fused framed steps against the
    # composed stepper, rtol = atol = 1e-10. Float32 at icos48 x 100 x 2:
    # per channel max|diff| / max|ref| <= FCT_F32 for both stages, ten times
    # the worst first reading on the card (stage A's u, which sums the
    # momentum terms in another order than the plain version: 6.0e-8;
    # stage A's other channels and stage B read 0, PERF.md); over ten
    # framed steps at u = 0.5 x noise the kernels' range of the 0/1 tracer
    # passes the plain versions' by at most MONO_ULPS ulps of 1 at either
    # end. Also the FCT fix submesh's size, the host build of the FCT
    # extension (icos_mega.ensure_fct) and of the FCT prep, and the parts of
    # a step: the submesh's composed stages, the refresh between the stages
    # and the final one
    FCT_F32 = 6.0e-7
    FCT_VARIANTS = {
        "center": ({}, {}),
        "center_wind_drag": ({}, SCI_WIND_DRAG),
        "upwind_thickness": (dict(flux_thickness_type="upwind"), {}),
        "upwind_thickness_wind_drag": (dict(flux_thickness_type="upwind"),
                                       SCI_WIND_DRAG)}
    FCT_NAMES = names[:4] + [f"{nm}{l}" for l in range(NTRACERS)
                             for nm in ("trtd", "facc")]

    def sphere_fct_state(mesh_np, K, dtype, u_amp):
        """the sphere's h of sphere_state, u = u_amp x noise x edge_mask,
        tracer 0 a 0/1 spherical cap (cos lat cos lon > 0.7), tracer 1
        10"""
        st = sphere_state(mesh_np, K, NTRACERS, dtype, u_amp, 0.0)
        lat = np.asarray(mesh_np.lat_cell)
        lon = np.asarray(mesh_np.lon_cell)
        cap = (np.cos(lat) * np.cos(lon) > 0.7).astype(np.float64)
        tr = st.tracers.clone()
        tr[0] = put(cap[:, None] * np.ones((1, K)), dtype)
        return ModelState(h=st.h, u=st.u, tracers=tr)

    def fct_stages(p, cfg_v, fr, fix, wind=None):
        """both stages, kernel and plain, on the same inputs: (stage A
        kernel, plain; stage B kernel into a copy of the frames, plain; the
        refreshed plain stage-A output stage B read)"""
        got_a = patch_megastep.fct_a(p, cfg_v, fr, DT, wind=wind)
        ref_a = patch_megastep.fct_a_plain(p, cfg_v, fr, DT, wind=wind)
        mid_fix, _ = patch_megastep.fct_sub_a(p, cfg_v, fr, fix, 0.0, DT,
                                              wind)
        mid = patch_megastep.fct_refresh_mid(p, ref_a.clone(), mid_fix)
        got_b = patch_megastep.fct_b(p, cfg_v, mid, fr, DT, fr.clone())
        ref_b = patch_megastep.fct_b_plain(p, cfg_v, mid, fr, DT)
        torch.cuda.synchronize()
        return got_a, ref_a, got_b, ref_b, mid

    def fct_errs(got_a, ref_a, got_b, ref_b):
        return {"stage_a": {n_: chan_err(got_a[:, c][None], ref_a[:, c][None])
                            for c, n_ in enumerate(FCT_NAMES)},
                "stage_b": {f"tracer{l}": chan_err(got_b[:, 4 + l][None],
                                                   ref_b[:, l][None])
                            for l in range(NTRACERS)}}

    fcr = {"tolerance": "f64 per channel max|diff| <= 1e-14 max|ref| "
           "against plain, fused framed steps vs composed steps rtol=atol="
           "1e-10 over 3 steps; f32 per channel max|diff| <= FCT_F32 of "
           "max|ref|; the 0/1 tracer's range over 10 framed steps at u = 0.5"
           f" x noise within {MONO_ULPS} ulps of 1 of the plain versions'",
           "FCT_F32": FCT_F32, "passes_per_step": {
               "stage_a": patch_megastep.PASSES,
               "stage_b": patch_megastep.FCT_B_PASSES},
           "f64_icos16x8x2": {}}
    st16f = sphere_fct_state(m16_np, 8, torch.float64, 0.1)
    p16f = patch_megastep.prep(m16, torch.float64, dev, fct=True)
    for variant, (kw, tend) in FCT_VARIANTS.items():
        cfg_v = bench_cfg(8, NTRACERS, dict(eddy_diff4=1e9, **tend),
                          flux_tracer_type="fct", **kw)
        if not patch_megastep.supported(m16, cfg_v, framed=True) \
                or patch_megastep.supported(m16, cfg_v):
            fail(f"sphere FCT {variant}: not fused on the framed path alone")
        fr16, fix16 = patch_megastep.stack_frames(m16, cfg_v, st16f)
        pw16 = patch_megastep.make_wind(m16, cfg_v, w16, torch.float64)
        got_a, ref_a, got_b, ref_b, _ = fct_stages(p16f, cfg_v, fr16,
                                                   fix16, pw16)
        errs = fct_errs(got_a, ref_a, got_b, ref_b)
        worst = max(v for e in errs.values() for v in e.values())
        if not worst <= 1e-14 or not bool(torch.isfinite(got_a).all()) \
                or not bool(torch.isfinite(got_b).all()) \
                or not bool(torch.equal(got_b[:, :4], fr16[:, :4])):
            fail(f"sphere FCT {variant} kernels vs plain at icos16 f64: "
                 f"{errs}")
        fcr["f64_icos16x8x2"][variant] = errs
    # whole steps: the framed fused path against the composed stepper
    fcr["f64_icos16_steps_vs_composed"] = {}
    for variant in ("center", "upwind_thickness_wind_drag"):
        kw, tend = FCT_VARIANTS[variant]
        cfg_v = bench_cfg(8, NTRACERS, dict(eddy_diff4=1e9, **tend),
                          flux_tracer_type="fct", **kw)
        reset_fct = (patch_megastep.fct_a_launches,
                     patch_megastep.fct_b_launches)
        ker = run_steps(m16, cfg_v, st16f, 0.0, DT, 3, wind_stress=w16)
        got_l = (patch_megastep.fct_a_launches - reset_fct[0],
                 patch_megastep.fct_b_launches - reset_fct[1])
        if got_l != (3 * patch_megastep.PASSES,
                     3 * patch_megastep.FCT_B_PASSES):
            fail(f"fused sphere FCT steps ({variant}): launches {got_l} in 3")
        comp = st16f
        for i in range(3):
            comp = composed(forward_backward_step, m16, cfg_v, comp, i * DT,
                            DT, wind_stress=w16)
        torch.cuda.synchronize()
        worst = 0.0
        for a_, b_ in zip(ker, comp):
            d = (a_ - b_).abs()
            if bool((d > 1e-10 + 1e-10 * b_.abs()).any()) \
                    or not bool(torch.isfinite(a_).all()):
                fail(f"fused sphere FCT steps ({variant}) vs composed at "
                     f"icos16 f64: {d.max().item()}")
            worst = max(worst, d.max().item())
        fcr["f64_icos16_steps_vs_composed"][variant] = worst
    del fr16, got_a, ref_a, got_b, ref_b, ker, comp

    # float32 at bench.py's sphere width: the host build of the FCT
    # extension (the FCT tables, masks and fix closure) and of the FCT
    # prep, both stages against plain in every variant, their times and the
    # parts of a framed step (center thickness flux, no tails)
    from omega_tpu_torch.mesh import icos_mega
    t_m = time.perf_counter()
    icos_mega.ensure_fct(m48)
    fct_mega_s = time.perf_counter() - t_m
    p48f = patch_megastep.prep(m48, torch.float32, dev, fct=True)
    fct_build_s = time.perf_counter() - t_m
    st48f = sphere_fct_state(m48_np, NLAYERS, torch.float32, 0.05)
    f32_errs = {}
    for variant, (kw, tend) in FCT_VARIANTS.items():
        cfg_v = bench_cfg(NLAYERS, NTRACERS, tend, flux_tracer_type="fct",
                          **kw)
        fr48, fix48 = patch_megastep.stack_frames(m48, cfg_v, st48f)
        pw48 = patch_megastep.make_wind(m48, cfg_v, w48, torch.float32)
        got_a, ref_a, got_b, ref_b, mid = fct_stages(p48f, cfg_v, fr48,
                                                     fix48, pw48)
        errs = fct_errs(got_a, ref_a, got_b, ref_b)
        if max(max(e.values()) for e in errs.values()) > FCT_F32 \
                or not bool(torch.isfinite(got_a).all()) \
                or not bool(torch.isfinite(got_b).all()):
            fail(f"sphere FCT {variant} kernels at icos{N_SPHERE} f32: "
                 f"{errs}")
        f32_errs[variant] = errs
        if variant != "center":
            del got_a, ref_a, got_b, ref_b, mid
    cfg48f = bench_cfg(NLAYERS, NTRACERS, flux_tracer_type="fct")
    fr48, fix48 = patch_megastep.stack_frames(m48, cfg48f, st48f)
    got_a, ref_a, got_b, ref_b, mid = fct_stages(p48f, cfg48f, fr48, fix48)
    a_abs = (got_a - ref_a).abs().max().item()
    b_abs = (got_b[:, 4:] - ref_b).abs().max().item()
    mid48 = patch_megastep.new_mid(fr48)
    work48 = patch_megastep.new_work(fr48)
    out48 = torch.empty_like(fr48)
    fa_ms = cuda_ms(lambda: patch_megastep.fct_a(
        p48f, cfg48f, fr48, DT, mid48, work48), 20)
    fa_plain_ms = cuda_ms(lambda: patch_megastep.fct_a_plain(
        p48f, cfg48f, fr48, DT), 2, 1)
    fa_passes = fb_passes(lambda: patch_megastep.fct_a(
        p48f, cfg48f, fr48, DT, mid48, work48), cfg48f, False)
    fb_ms = cuda_ms(lambda: patch_megastep.fct_b(
        p48f, cfg48f, mid, fr48, DT, out48, work48), 20)
    # stage B pass by pass: device time (torch.profiler over whole calls),
    # registers, spill and blocks per SM, each pass's bound
    fb_attrs = patch_megastep.fct_b_attrs(cfg48f, torch.float32)
    fb_pass_b = port_bounds.patch_fct_b_passes(N_SPHERE)
    fb_passes = {
        nm: {"ms": ms, **fb_attrs[nm],
             "bound_ms": fb_pass_b[nm]["bound_ms"],
             "bound_by": fb_pass_b[nm]["bound_by"]}
        for nm, ms in kernel_ms(lambda: patch_megastep.fct_b(
            p48f, cfg48f, mid, fr48, DT, out48, work48),
            {nm: f"fct::pass_{nm}<"
             for nm in patch_megastep.FCT_B_PASS_NAMES}).items()}
    fb_plain_ms = cuda_ms(lambda: patch_megastep.fct_b_plain(
        p48f, cfg48f, mid, fr48, DT), 2, 1)
    mid_fix48, sub_a48 = patch_megastep.fct_sub_a(p48f, cfg48f, fr48, fix48,
                                                  0.0, DT)
    fsub_ms = cuda_ms(lambda: patch_megastep.fct_sub_b(
        p48f, mid, mid_fix48, patch_megastep.fct_sub_a(
            p48f, cfg48f, fr48, fix48, 0.0, DT)[1], DT), 20)
    scratch48 = ref_a.clone()
    fmid_ms = cuda_ms(lambda: patch_megastep.fct_refresh_mid(
        p48f, scratch48, mid_fix48), 20)
    nfix48 = patch_megastep.fct_sub_b(p48f, mid, mid_fix48, sub_a48, DT)
    scratch48 = got_b.clone()
    ffin_ms = cuda_ms(lambda: patch_megastep._refresh_frames(
        p48f, scratch48, nfix48, p48f.persist), 20)
    fstep_ms = cuda_ms(lambda: patch_megastep.fct_patch_megastep_framed(
        m48, cfg48f, (fr48, fix48), 0.0, DT, out48, work48, None, mid48), 10)
    del scratch48, got_a, ref_a, got_b, ref_b, mid

    # the kernels' range against the plain versions' over ten framed steps
    # in the reference's flow, tracer diffusion off (sphere_fct_path's
    # configuration)
    cfg_sf = bench_cfg(NLAYERS, NTRACERS, dict(eddy_diff2=0.0,
                                               eddy_diff4=0.0),
                       flux_tracer_type="fct")

    def plain_fct_a(p, cfg_v, fr, dt, out=None, work=None, wind=None):
        return patch_megastep.fct_a_plain(p, cfg_v, fr, dt, out, wind)

    def plain_fct_b(p, cfg_v, mid, fr, dt, out, work=None):
        out[:, 4:] = patch_megastep.fct_b_plain(p, cfg_v, mid, fr, dt)
        return out

    def fct_range(plain):
        carry = patch_megastep.stack_frames(
            m48, cfg_sf, sphere_fct_state(m48_np, NLAYERS, torch.float32,
                                          0.5))
        keep = patch_megastep.fct_a, patch_megastep.fct_b
        if plain:
            patch_megastep.fct_a, patch_megastep.fct_b = plain_fct_a, \
                plain_fct_b
        try:
            for i in range(10):
                carry = patch_megastep.fct_patch_megastep_framed(
                    m48, cfg_sf, carry, i * DT, DT)
        finally:
            patch_megastep.fct_a, patch_megastep.fct_b = keep
        t0 = patch_megastep.unstack_frames(m48, cfg_sf, carry,
                                           ModelState).tracers[0]
        return t0.min().item(), t0.max().item()

    (k_lo, k_hi), (p_lo, p_hi) = fct_range(False), fct_range(True)
    ulps = MONO_ULPS * torch.finfo(torch.float32).eps
    rng_rec = {"min": k_lo, "max": k_hi, "plain_min": p_lo, "plain_max": p_hi}
    if k_lo < p_lo - ulps or k_hi > p_hi + ulps:
        fail(f"sphere FCT kernels' range past the plain versions': {rng_rec}")
    pfb = port_bounds.patch_fct(N_SPHERE)
    fcr[f"f32_icos{N_SPHERE}x{NLAYERS}x{NTRACERS}"] = {
        "errors": f32_errs, "stage_a_max_abs_err": a_abs,
        "stage_b_max_abs_err": b_abs,
        "stage_a_ms": fa_ms, "stage_a_plain_ms": fa_plain_ms,
        "stage_a_passes": fa_passes,
        "stage_b_ms": fb_ms, "stage_b_plain_ms": fb_plain_ms,
        "stage_b_passes": fb_passes,
        "stage_a_bound_ms": pfb["stage_a"]["bound_ms"],
        "stage_a_bound_by": pfb["stage_a"]["bound_by"],
        "stage_b_bound_ms": pfb["stage_b"]["bound_ms"],
        "stage_b_bound_by": pfb["stage_b"]["bound_by"],
        "step_bound_ms": pfb["bound_ms"], "step_ms": fstep_ms,
        "submesh_step_ms": fsub_ms, "mid_refresh_ms": fmid_ms,
        "final_refresh_ms": ffin_ms, "host_build_s": fct_build_s,
        "ensure_fct_s": fct_mega_s,
        "submesh_cells": int(p48f.sub_cells.numel()),
        "fix_cells": int(p48f.fix_cells_global.numel()),
        "fix_edges": int(p48f.fix_edges_global.numel()),
        "fb_submesh_cells": int(p48.sub_cells.numel()),
        "range_10_steps_u_amp_0.5": rng_rec}
    emit({"phase": "kernel_patch_fct", **fcr})
    fcv = fcr[f"f32_icos{N_SPHERE}x{NLAYERS}x{NTRACERS}"]
    del fr48, mid48, work48, out48

    # ------------------------------------------------ 4h. kernel_patch_rk
    # the RK stages on the sphere (csrc/patch_rk.cuh, four launches per
    # call) against their plain version on the same inputs: every mode
    # (RK_PROV from the step's frames and from a provisional level, RK_FIRST,
    # RK_MID, RK_LAST), every pair of flux types, with and without the wind /
    # drag tails, the provisional level and the accumulator being what RK4's
    # first stage makes of the frames. Float64 at icos16 x 8 x 2: per channel
    # max|diff| <= 1e-12 max|ref| of out and of the accumulator; three fused
    # framed RK2 steps (the science configuration: upwind fluxes, wind,
    # drag, PP81) and three RK4 steps (flagship) against the composed
    # steppers, rtol = atol = 1e-10. Float32 at icos48 x 100 x 2 by the
    # increment per channel, limit PATCH_INCR (out against the level the
    # stage starts from, the accumulator against what it holds before the
    # stage adds to it). Each mode's time over 20 launches at the paths'
    # shapes, the plain version's, the pole submesh's tendencies (one per
    # stage) and the refresh
    from omega_tpu_torch.core import tendencies as tend_mod
    RK_PROV, RK_FIRST = patch_megastep.RK_PROV, patch_megastep.RK_FIRST
    RK_MID, RK_LAST = patch_megastep.RK_MID, patch_megastep.RK_LAST
    # mode name -> (mode, a, b, the level: the frames or a provisional one)
    RK_CASES = {"prov_a": (RK_PROV, 0.5, 0.0, False),
                "prov_b": (RK_PROV, 1.0, 0.0, True),
                "first": (RK_FIRST, 0.5, 1.0 / 6.0, False),
                "mid": (RK_MID, 0.5, 1.0 / 3.0, True),
                "last": (RK_LAST, 0.0, 1.0 / 6.0, True)}
    # the kernel of each RK pass (csrc/patch_rk.cuh) and of splitpre's
    # (csrc/patch_split.cu), as the profiler names them
    RK_PASS_KERNELS = dict(zip(patch_megastep.RK_PASS_NAMES, (
        "rk_pass_a<", "rk_pass_b<", "rk_pass_c<", "rk_pass_d_cells<",
        "rk_pass_d_edges<")))
    SPLIT_PRE_KERNELS = {nm: "ssh_column<" if nm == "ssh"
                         else RK_PASS_KERNELS[nm]
                         for nm in patch_megastep.SPLIT_PRE_PASS_NAMES}
    RK_VARIANTS = {
        "cc": ({}, {}), "uc": (dict(flux_thickness_type="upwind"), {}),
        "cu": (dict(flux_tracer_type="upwind"), {}), "uu": (UPWIND, {}),
        "cc_wind_drag": ({}, SCI_WIND_DRAG),
        "uc_wind_drag": (dict(flux_thickness_type="upwind"), SCI_WIND_DRAG),
        "cu_wind_drag": (dict(flux_tracer_type="upwind"), SCI_WIND_DRAG),
        "uu_wind_drag": (UPWIND, SCI_WIND_DRAG)}

    def rk_inputs(p, cfg_v, fr, wind):
        """(provisional level, accumulator, the accumulator's start (h, u,
        tr h of the frames), RK_LAST's start (the accumulator's h, u and tr
        h / h)) of a step from the frames `fr`"""
        acc, prov = patch_megastep.rk_stage_plain(
            p, cfg_v, RK_FIRST, 0.5 * DT, DT / 6.0, fr, fr, None, wind)
        trh = fr.clone()
        trh[:, 4:] *= fr[:, :1]
        last0 = acc.clone()
        last0[:, 4:] = torch.where(acc[:, :1] != 0, acc[:, 4:]
                                   / torch.where(acc[:, :1] != 0, acc[:, :1],
                                                 torch.ones_like(acc[:, :1])),
                                   torch.zeros_like(acc[:, 4:]))
        return prov, acc, trh, last0

    def rk_call(p, cfg_v, case, fr, prov, acc, wind, out, acc_out, work):
        """one stage, kernel into `out` / `acc_out`; the plain version"""
        mode, a, b, on_prov = RK_CASES[case]
        ev = prov if on_prov else fr
        patch_megastep.rk_stage(
            p, cfg_v, mode, a * DT, b * DT, ev, out,
            base=None if mode == RK_LAST else fr,
            acc=acc if mode in (RK_MID, RK_LAST) else None,
            acc_out=acc_out if mode in (RK_FIRST, RK_MID) else None,
            work=work, wind=wind)
        return patch_megastep.rk_stage_plain(p, cfg_v, mode, a * DT, b * DT,
                                             ev, fr, acc, wind)

    def rk_starts(case, fr, acc, trh, last0):
        """(out's start, the accumulator's start) of a mode"""
        mode = RK_CASES[case][0]
        return (last0 if mode == RK_LAST else fr,
                trh if mode == RK_FIRST else acc)

    rkp = {"tolerance": "f64 per channel max|diff| <= 1e-12 max|ref| "
           "against plain (out and the accumulator), fused framed RK2 / RK4 "
           "steps vs composed steps rtol=atol=1e-10 over 3 steps; f32 per "
           "channel the error of the increment <= PATCH_INCR of the largest "
           "increment", "PATCH_INCR": PATCH_INCR,
           "passes_per_call": patch_megastep.RK_PASSES,
           "f64_icos16x8x2": {}}
    for variant, (kw, tend) in RK_VARIANTS.items():
        cfg_v = bench_cfg(8, NTRACERS, dict(eddy_diff4=1e9, **tend), **kw)
        for rk_kind in ("rk2", "rk4"):
            if not patch_megastep.supported(m16, cfg_v, framed=True,
                                            kind=rk_kind):
                fail(f"sphere {rk_kind} {variant} not supported by the fused "
                     "path")
        fr16, _ = patch_megastep.stack_frames(m16, cfg_v, st16s)
        pw16 = patch_megastep.make_wind(m16, cfg_v, w16, torch.float64)
        prov, acc, _, _ = rk_inputs(p16, cfg_v, fr16, pw16)
        errs = {}
        for case in RK_CASES:
            out16, acc16 = torch.empty_like(fr16), torch.empty_like(fr16)
            ref_acc, ref = rk_call(p16, cfg_v, case, fr16, prov, acc, pw16,
                                   out16, acc16, None)
            torch.cuda.synchronize()
            e = [chan_err(out16[:, c][None], ref[:, c][None])
                 for c in range(len(names))]
            if ref_acc is not None:
                e += [chan_err(acc16[:, c][None], ref_acc[:, c][None])
                      for c in range(len(names))]
            errs[case] = max(e)
            if not max(e) <= 1e-12 or not bool(torch.isfinite(out16).all()):
                fail(f"sphere RK stage {variant} {case} vs plain at icos16 "
                     f"f64: {e}")
        rkp["f64_icos16x8x2"][variant] = errs
    # whole steps: the framed fused path against the composed steppers
    rkp["f64_icos16_steps_vs_composed"] = {}
    for rk_kind, stepper, cfg_v, st_v in (("rk2", rk2_step, cfg16s, st16s),
                                          ("rk4", rk4_step, cfg16, st16)):
        patch_megastep.rk_launches = 0
        patch_megastep.coeff_launches = patch_megastep.solve_launches = 0
        ker = run_steps(m16, cfg_v, st_v, 0.0, DT, 3, stepper=stepper,
                        wind_stress=w16)
        got_l = (patch_megastep.rk_launches, patch_megastep.coeff_launches,
                 patch_megastep.solve_launches)
        mix = 3 if vmix_kernel.vmix_on(cfg_v) else 0
        stages = 2 if rk_kind == "rk2" else 4
        want_l = (stages * 3 * patch_megastep.RK_PASSES,
                  mix if cfg_v.vert_mix.scheme == "pp81" else 0, mix)
        if got_l != want_l:
            fail(f"fused sphere {rk_kind} steps: launches {got_l}, expected "
                 f"{want_l}")
        comp = st_v
        for i in range(3):
            comp = composed(stepper, m16, cfg_v, comp, i * DT, DT,
                            wind_stress=w16)
        torch.cuda.synchronize()
        worst = 0.0
        for a_, b_ in zip(ker, comp):
            d = (a_ - b_).abs()
            if bool((d > 1e-10 + 1e-10 * b_.abs()).any()) \
                    or not bool(torch.isfinite(a_).all()):
                fail(f"fused sphere {rk_kind} steps vs composed at icos16 "
                     f"f64: {d.max().item()}")
            worst = max(worst, d.max().item())
        rkp["f64_icos16_steps_vs_composed"][rk_kind] = worst
    del fr16, prov, acc, ker, comp

    # float32 at bench.py's sphere width: the flagship variant (sphere_rk4
    # _path's) and the science variant (sphere_rk2_path's), every mode
    prb = port_bounds.patch_rk(N_SPHERE)
    rk_stage_of = {"prov_a": "rk2a", "prov_b": "rk2b", "first": "rk4s1",
                   "mid": "rk4s2", "last": "rk4s4"}
    f32 = {}
    for variant, cfg_v, st_v in (("cc", cfg48, st48),
                                 ("uu_wind_drag", cfg48s, st48s)):
        fr48, fix48 = patch_megastep.stack_frames(m48, cfg_v, st_v)
        pw48 = patch_megastep.make_wind(m48, cfg_v, w48, torch.float32)
        prov, acc, trh, last0 = rk_inputs(p48, cfg_v, fr48, pw48)
        out48, acc48 = torch.empty_like(fr48), torch.empty_like(fr48)
        work48 = fr48.new_empty(patch_megastep.rk_work_fields(NTRACERS)
                                * NLAYERS * p48.P)
        res = {}
        for case in RK_CASES:
            ref_acc, ref = rk_call(p48, cfg_v, case, fr48, prov, acc, pw48,
                                   out48, acc48, work48)
            torch.cuda.synchronize()
            s_out, s_acc = rk_starts(case, fr48, acc, trh, last0)
            inc = incr_err(out48.transpose(0, 1), ref.transpose(0, 1),
                           s_out.transpose(0, 1))
            rec = {"increments": dict(zip(names, inc)),
                   "max_abs_err": (out48 - ref).abs().max().item()}
            if ref_acc is not None:
                inc_a = incr_err(acc48.transpose(0, 1),
                                 ref_acc.transpose(0, 1),
                                 s_acc.transpose(0, 1))
                rec["acc_increments"] = dict(zip(names, inc_a))
                inc = inc + inc_a
            if max(inc) > PATCH_INCR or not bool(torch.isfinite(out48).all()):
                fail(f"sphere RK stage {variant} {case} at icos{N_SPHERE} "
                     f"f32: {rec}")
            del ref, ref_acc
            mode, a, b, on_prov = RK_CASES[case]
            ev = prov if on_prov else fr48
            rec["ms"] = cuda_ms(lambda: patch_megastep.rk_stage(
                p48, cfg_v, mode, a * DT, b * DT, ev, out48,
                base=None if mode == RK_LAST else fr48,
                acc=acc if mode in (RK_MID, RK_LAST) else None,
                acc_out=acc48 if mode in (RK_FIRST, RK_MID) else None,
                work=work48, wind=pw48), 20)
            bnd = prb["stages"][rk_stage_of[case]]
            rec.update(bound_ms=bnd["bound_ms"], bound_by=bnd["bound_by"])
            res[case] = rec
        # pass by pass (device time per launch from torch.profiler over
        # whole calls) at the mode the kernels line reports, with its
        # registers and spill
        tm = "mid" if variant == "cc" else "prov_b"
        t_mode, t_a, t_b, t_prov = RK_CASES[tm]
        t_ev = prov if t_prov else fr48
        attrs = patch_megastep.rk_pass_attrs(
            cfg_v, torch.float32,
            pw48 is not None or patch_megastep._drag_on(cfg_v))
        res["passes_mode"] = tm
        pbs = prb["passes"][rk_stage_of[tm]]
        res["passes"] = {
            nm: {"ms": ms, **attrs[nm], "bound_ms": pbs[nm]["bound_ms"]}
            for nm, ms in kernel_ms(
                lambda: patch_megastep.rk_stage(
                    p48, cfg_v, t_mode, t_a * DT, t_b * DT, t_ev, out48,
                    base=None if t_mode == RK_LAST else fr48,
                    acc=acc if t_mode in (RK_MID, RK_LAST) else None,
                    acc_out=acc48 if t_mode in (RK_FIRST, RK_MID) else None,
                    work=work48, wind=pw48), RK_PASS_KERNELS).items()}
        # the plain version at the widest mode, once
        res["mid"]["plain_ms"] = cuda_ms(
            lambda: patch_megastep.rk_stage_plain(
                p48, cfg_v, RK_MID, 0.5 * DT, DT / 3.0, prov, fr48, acc,
                pw48), 2, 1)
        # the host parts of a stage: the pole submesh's tendencies and the
        # refresh of one set of frames
        sub_v = patch_megastep._sub_state(p48, fr48, fix48)
        res["submesh_tendencies_ms"] = cuda_ms(
            lambda: tend_mod.compute_all_tendencies(
                p48.sub_mesh, cfg_v, *sub_v, 0.0, None if pw48 is None
                else pw48[1]), 20)
        nfix48 = dict(h=sub_v.h[p48.fix_cells_local],
                      u=sub_v.u[p48.fix_edges_local],
                      tr=sub_v.tracers[:, p48.fix_cells_local])
        res["refresh_ms"] = cuda_ms(lambda: patch_megastep._refresh_frames(
            p48, out48, nfix48, p48.persist), 20)
        f32[variant] = res
        del fr48, prov, acc, trh, last0, out48, acc48, work48, sub_v
    f32["rk2_step_bound_ms"] = prb["rk2_step"]["bound_ms"]
    f32["rk4_step_bound_ms"] = prb["rk4_step"]["bound_ms"]
    f32["rk2_science_step_bound_ms"] = prb["rk2_step_science"]["bound_ms"]
    f32["rk4_stages_ms"] = sum(f32["cc"][c]["ms"] for c in
                               ("first", "mid", "mid", "last"))
    f32["rk2_science_stages_ms"] = sum(f32["uu_wind_drag"][c]["ms"] for c in
                                       ("prov_a", "prov_b"))
    rkp[f"f32_icos{N_SPHERE}x{NLAYERS}x{NTRACERS}"] = f32
    emit({"phase": "kernel_patch_rk", **rkp})
    rkpv = f32

    # --------------------------------------------- 4i. kernel_patch_split
    # the split-explicit step on the sphere (csrc/patch_split.cu: splitpre,
    # five launches, and splitpost, four; csrc/bt_gather.cu: the
    # barotropic subcycles, one cooperative launch) against their plain versions
    # on the same inputs, at the flat phase's own inputs (the mode split and
    # the slow forcing of the state). Float64 at icos16 x 8 x 2: splitpre's
    # du_out per channel max|diff| <= SPLIT_F64 max|ref| (its momentum terms
    # summed in another order than the chain's, as the RK stage's), splitpost
    # and the subcycles likewise (the subcycles' tangential and divergence
    # sums run in slot order, the plain loop's patch stencils in their entry
    # order); three fused framed split steps against the composed split
    # stepper, rtol = atol = 1e-10. Float32 at icos48 x 100 x 2: du_out per
    # channel max|diff| / max|ref| <= PATCH_INCR (du_out is itself the
    # increment per unit dt), splitpost and the subcycles by the increment
    # per channel, PATCH_INCR. M = 10 with bt_drag 0 and 1e-4; the
    # subcycles also at icos48 for every BT_CASES case, float64 per output
    # within 1e-12 of max|ref| and float32 by the increment, PATCH_INCR
    SPLIT_F64 = 1e-14
    cfg16p = bench_cfg(8, NTRACERS, dict(eddy_diff4=1e9),
                       ssh_formulation="column")
    cfg48p = bench_cfg(NLAYERS, NTRACERS, ssh_formulation="column")
    for m_, c_ in ((m16, cfg16p), (m48, cfg48p)):
        if not patch_megastep.split_patch_supported(m_, c_):
            fail("sphere split configuration not supported by the framed "
                 "path")
    from omega_tpu_torch.ops import trisk
    from omega_tpu_torch.stepping.split import (_depth_avg_edge,
                                                split_forward_backward_step)

    def split_inputs(mesh_, p, cfg_v, st, fr):
        """(the flat phase's subcycle inputs (ubar, ssh, g_slow, het), the
        frames with the transport velocity in their u channels) of a
        state, from the plain splitpre and the plain subcycles"""
        du = patch_megastep.split_du(mesh_, cfg_v, p,
                                     patch_megastep.split_pre_plain(
                                         p, cfg_v, fr), st.h, st.u, 0.0)
        he = trisk.cell_mean_on_edge(mesh_, st.h)
        ubar = _depth_avg_edge(he, st.u)
        ssh = st.h.sum(-1, keepdim=True) - trisk.col(mesh_, "bottom_depth")
        gs = _depth_avg_edge(he, du) - bt_gather.fast(mesh_, ubar, ssh,
                                                      cfg_v.gravity)
        ins = (ubar, ssh, gs, he.sum(-1, keepdim=True))
        _, _, avg = bt_gather.subcycles_plain(
            mesh_, *ins, gravity=cfg_v.gravity, dt_bt=DT_SPLIT / M_SPLIT,
            n_subcycles=M_SPLIT)
        ft = fr.clone()
        patch_megastep._frames_of(p, "edge", st.u - ubar + avg, 3,
                                  ft[:, 1:4])
        return ins, ft

    def split_checks(mesh_, p, cfg_v, st, work=None):
        """every split kernel against its plain version on `st`: (record,
        the inputs)"""
        fr, _ = patch_megastep.stack_frames(mesh_, cfg_v, st)
        du = patch_megastep.split_pre(p, cfg_v, fr, work=work)
        ref = patch_megastep.split_pre_plain(p, cfg_v, fr)
        ins, ft = split_inputs(mesh_, p, cfg_v, st, fr)
        out = torch.zeros_like(fr)
        patch_megastep.split_post(p, cfg_v, ft, DT_SPLIT, out, work=work)
        ref_post = patch_megastep.split_post_plain(p, cfg_v, ft, DT_SPLIT)
        torch.cuda.synchronize()
        post = torch.cat([out[:, :1], out[:, 4:]], 1)
        start = torch.cat([ft[:, :1], ft[:, 4:]], 1)
        rec = {"split_pre": [chan_err(du[:, c][None], ref[:, c][None])
                             for c in range(3)],
               "split_pre_max_abs_err": (du - ref).abs().max().item(),
               "split_post": [chan_err(post[:, c][None], ref_post[:, c][None])
                              for c in range(1 + NTRACERS)],
               "split_post_increments": incr_err(
                   post.transpose(0, 1), ref_post.transpose(0, 1),
                   start.transpose(0, 1)),
               "split_post_max_abs_err": (post - ref_post).abs().max().item(),
               "split_post_u_untouched": bool((out[:, 1:4] == 0).all())}
        dead_e = mesh_.edge_mask == 0
        for r in (0.0, 1e-4):
            kw = dict(gravity=cfg_v.gravity, dt_bt=DT_SPLIT / M_SPLIT,
                      n_subcycles=M_SPLIT, bt_drag=r)
            got_bt = bt_gather.bt_subcycles(mesh_, *ins, **kw)
            ref_bt = bt_gather.subcycles_plain(mesh_, *ins, **kw)
            torch.cuda.synchronize()
            rec[f"bt_drag_{r}"] = {
                "rel": [nerr(a_, b_) for a_, b_ in zip(got_bt, ref_bt)],
                "increments": [incr_err(a_.T, b_.T, s_.T)[0] for a_, b_, s_
                               in zip(got_bt, ref_bt,
                                      (ins[0], ins[1], ins[0]))],
                "max_abs_err": max((a_ - b_).abs().max().item()
                                   for a_, b_ in zip(got_bt, ref_bt)),
                "dead_edges": got_bt[0][dead_e].abs().max().item()
                if bool(dead_e.any()) else 0.0}
        return rec, (fr, ins, ft, out)

    spt = {"tolerance": "f64 per channel max|diff| <= SPLIT_F64 max|ref| "
           "against plain (splitpre, splitpost, the subcycles), fused "
           "framed split steps vs composed steps rtol=atol=1e-10 over 3 "
           "steps; f32 splitpre per channel max|diff|/max|ref| and "
           "splitpost and the subcycles per channel the error of the "
           "increment <= PATCH_INCR", "SPLIT_F64": SPLIT_F64,
           "PATCH_INCR": PATCH_INCR, "M": M_SPLIT, "dt": DT_SPLIT,
           "passes_per_call": {
               "split_pre": patch_megastep.SPLIT_PRE_PASSES,
               "split_post": patch_megastep.SPLIT_POST_PASSES,
               "bt_gather": 1}}
    st16p = sphere_state(m16_np, 8, NTRACERS, torch.float64, 0.1, 1.0)
    rec, _ = split_checks(m16, p16, cfg16p, st16p)
    worst = max(rec["split_pre"] + rec["split_post"]
                + [max(rec[f"bt_drag_{r}"]["rel"]) for r in (0.0, 1e-4)])
    if not worst <= SPLIT_F64 or max(rec[f"bt_drag_{r}"]["dead_edges"]
                                     for r in (0.0, 1e-4)) != 0.0:
        fail(f"sphere split kernels vs plain at icos16 f64: {rec}")
    spt["f64_icos16x8x2"] = rec
    # whole steps: the framed fused path against the composed stepper
    patch_megastep.split_pre_launches = 0
    patch_megastep.split_post_launches = bt_gather.launches = 0
    ker = run_steps(m16, cfg16p, st16p, 0.0, DT_SPLIT, 3,
                    stepper=split_forward_backward_step)
    got_l = (patch_megastep.split_pre_launches, bt_gather.launches,
             patch_megastep.split_post_launches)
    want_l = (3 * patch_megastep.SPLIT_PRE_PASSES,
              3,
              3 * patch_megastep.SPLIT_POST_PASSES)
    if got_l != want_l:
        fail(f"fused sphere split steps: launches {got_l}, expected "
             f"{want_l}")
    # and one step of the per-step API (a CUDA state takes the framed path)
    patch_megastep.split_pre_launches = 0
    one = split_forward_backward_step(m16, cfg16p, st16p, 0.0, DT_SPLIT)
    if patch_megastep.split_pre_launches != patch_megastep.SPLIT_PRE_PASSES:
        fail("split_forward_backward_step on the card did not take the "
             "framed path")
    comp = st16p
    for i in range(3):
        comp = composed(split_forward_backward_step, m16, cfg16p, comp,
                        i * DT_SPLIT, DT_SPLIT)
        if i == 0:
            comp1 = comp
    torch.cuda.synchronize()
    worst = 0.0
    for a_, b_ in list(zip(ker, comp)) + list(zip(one, comp1)):
        d = (a_ - b_).abs()
        if bool((d > 1e-10 + 1e-10 * b_.abs()).any()) \
                or not bool(torch.isfinite(a_).all()):
            fail(f"fused sphere split steps vs composed at icos16 f64: "
                 f"{d.max().item()}")
        worst = max(worst, d.max().item())
    spt["f64_icos16_steps_vs_composed"] = worst
    del ker, comp, comp1, one

    # float32 at bench.py's sphere width
    st48p = sphere_state(m48_np, NLAYERS, NTRACERS, torch.float32, 0.01,
                         1.0)
    fr48, _ = patch_megastep.stack_frames(m48, cfg48p, st48p)
    sc48 = patch_megastep.new_split_scratch(fr48)
    rec, (fr48, ins48, ft48, out48) = split_checks(m48, p48, cfg48p, st48p,
                                                   sc48["work"])
    f32_worst = max(rec["split_pre"] + rec["split_post_increments"]
                    + [max(rec[f"bt_drag_{r}"]["increments"])
                       for r in (0.0, 1e-4)])
    if not f32_worst <= PATCH_INCR or max(
            rec[f"bt_drag_{r}"]["dead_edges"] for r in (0.0, 1e-4)) != 0.0:
        fail(f"sphere split kernels vs plain at icos{N_SPHERE} f32: {rec}")
    # the subcycles at icos48, every case, float64 and float32
    bt_cases = {"f64": {}, "f32": {}}
    m48d = m48_np.to(dev, torch.float64)
    for nm, mesh_, ins_ in (("f32", m48, ins48),
                            ("f64", m48d, tuple(a.double() for a in ins48))):
        for M, r in BT_CASES:
            kw = dict(gravity=cfg48p.gravity, dt_bt=DT_SPLIT / M,
                      n_subcycles=M, bt_drag=r)
            got_bt = bt_gather.bt_subcycles(mesh_, *ins_, **kw)
            ref_bt = bt_gather.subcycles_plain(mesh_, *ins_, **kw)
            bt_cases[nm][f"M={M} r={r}"] = max(
                nerr(a_, b_) if nm == "f64" else
                incr_err(a_.T, b_.T, s_.T)[0] for a_, b_, s_
                in zip(got_bt, ref_bt, (ins_[0], ins_[1], ins_[0])))
    del m48d, got_bt, ref_bt
    if not (max(bt_cases["f64"].values()) <= 1e-12
            and max(bt_cases["f32"].values()) <= PATCH_INCR):
        fail(f"sphere subcycles vs plain at icos{N_SPHERE}: {bt_cases}")
    rec["bt_cases"] = bt_cases
    bt_kw = dict(gravity=cfg48p.gravity, dt_bt=DT_SPLIT / M_SPLIT,
                 n_subcycles=M_SPLIT)
    bt_bufs = bt_gather.new_buffers(ins48[0], ins48[1])
    psb, bbt = port_bounds.patch_split(N_SPHERE), port_bounds.sphere_bt(
        N_SPHERE, M_SPLIT)
    rec.update(
        split_pre_ms=cuda_ms(lambda: patch_megastep.split_pre(
            p48, cfg48p, fr48, out=sc48["du"], work=sc48["work"]), 20),
        split_pre_plain_ms=cuda_ms(lambda: patch_megastep.split_pre_plain(
            p48, cfg48p, fr48), 2, 1),
        split_post_ms=cuda_ms(lambda: patch_megastep.split_post(
            p48, cfg48p, ft48, DT_SPLIT, out48, work=sc48["work"]), 20),
        split_post_plain_ms=cuda_ms(lambda: patch_megastep.split_post_plain(
            p48, cfg48p, ft48, DT_SPLIT), 2, 1),
        bt_ms=cuda_ms(lambda: bt_gather.bt_subcycles(
            m48, *ins48, **bt_kw, out=bt_bufs[0], work=bt_bufs[1]), 20),
        bt_device_ms=kernel_ms(lambda: bt_gather.bt_subcycles(
            m48, *ins48, **bt_kw, out=bt_bufs[0], work=bt_bufs[1]),
            {"bt": "bt_gather_kernel"})["bt"],
        bt_attrs=bt_gather.attrs(torch.float32, m48),
        bt_plain_ms=cuda_ms(lambda: bt_gather.subcycles_plain(
            m48, *ins48, **bt_kw), 2, 1),
        split_pre_bound_ms=psb["splitpre"]["bound_ms"],
        split_pre_bound_by=psb["splitpre"]["bound_by"],
        split_post_bound_ms=psb["splitpost"]["bound_ms"],
        split_post_bound_by=psb["splitpost"]["bound_by"],
        bt_bound_ms=bbt[f"M{M_SPLIT}"]["bound_ms"],
        bt_bound_by=bbt[f"M{M_SPLIT}"]["bound_by"],
        bt_subcycle_bound_ms=bbt["subcycle"]["bound_ms"],
        bt_each_from_memory_bound_ms=bbt[f"M{M_SPLIT}_each_from_memory"][
            "bound_ms"])
    # splitpre pass by pass: device time per launch (torch.profiler over
    # whole calls), registers and spill (cudaFuncGetAttributes)
    sp_attrs = patch_megastep.split_pre_attrs(torch.float32)
    rec["split_pre_passes"] = {
        nm: {"ms": ms, **sp_attrs[nm]}
        for nm, ms in kernel_ms(
            lambda: patch_megastep.split_pre(
                p48, cfg48p, fr48, out=sc48["du"], work=sc48["work"]),
            SPLIT_PRE_KERNELS).items()}
    # splitpost pass by pass, likewise, with blocks per SM
    sq_attrs = patch_megastep.split_post_attrs(torch.float32)
    post_names = patch_megastep.FB_PASS_NAMES[
        :patch_megastep.SPLIT_POST_PASSES]
    rec["split_post_passes"] = {
        nm: {"ms": ms, **sq_attrs[nm]}
        for nm, ms in kernel_ms(
            lambda: patch_megastep.split_post(
                p48, cfg48p, ft48, DT_SPLIT, out48, work=sc48["work"]),
            {nm: FB_PASS_KERNELS[nm] for nm in post_names}).items()}
    # the host parts of a framed split step: the flat state's read-out, the
    # pole submesh's tendency and advance, the flat phase's composed
    # operators, and the refresh
    carry48 = patch_megastep.stack_frames(m48, cfg48p, st48p)
    h48, u48, tr48 = patch_megastep.unstack_frames(m48, cfg48p, carry48)

    def submesh_part():
        hs, us = h48[p48.sub_cells], u48[p48.sub_edges]
        tend_mod.compute_velocity_tendency(p48.sub_mesh, cfg48p, hs, us, 0.0)
        he = trisk.cell_mean_on_edge(p48.sub_mesh, hs)
        hn = hs + DT_SPLIT * -trisk.div_cell(p48.sub_mesh, he * us)
        tend_mod.compute_tracer_tendency(
            p48.sub_mesh, cfg48p, hs, us, tr48[:, p48.sub_cells], he, 0.0,
            h_new=hn, dt=DT_SPLIT, flux_h_edge=he)
    rec["submesh_ms"] = cuda_ms(submesh_part, 10)
    nfix48 = dict(h=h48[p48.fix_cells_global], u=u48[p48.fix_edges_global],
                  tr=tr48[:, p48.fix_cells_global])
    rec["refresh_ms"] = cuda_ms(lambda: patch_megastep._refresh_frames(
        p48, out48, nfix48, p48.persist), 20)
    # a whole framed step (its carry's u channels take the transport
    # velocity each time: the work is the same)
    rec["step_ms"] = cuda_ms(
        lambda: patch_megastep.split_patch_megastep_framed(
            m48, cfg48p, carry48, 0.0, DT_SPLIT, M_SPLIT, 0.0, out=out48,
            work=sc48), 5)
    rec["step_rest_ms"] = rec["step_ms"] - (
        rec["split_pre_ms"] + rec["bt_ms"] + rec["split_post_ms"]
        + rec["submesh_ms"] + rec["refresh_ms"])
    spt[f"f32_icos{N_SPHERE}x{NLAYERS}x{NTRACERS}"] = rec
    emit({"phase": "kernel_patch_split", **spt})
    sptv = rec
    del fr48, ft48, out48, sc48, ins48, h48, u48, tr48, carry48

    # --------------------------------------------------- 4j. kernel_gather
    # the gather kernel (csrc/gather.cu, one launch per pass) against its
    # plain version on each of the 16 tables of bench.py's OMEGA_PATCHES=0
    # sphere (reorder_mesh(spherical_icos_mesh(48)): RCM, the tables built)
    # at 100 layers in float32, with one and two leading indices (the FB
    # step calls both, port_bounds.FB_STEP_GATHERS): max|diff| <= 1e-6
    # max|ref|; the same at icos16 x 8 (and K = 1) in float64, 1e-14 (both
    # sum in slot order, every product rounded on its own). Per table and
    # leading count at icos48: the kernel's time by CUDA events over 20
    # launches, the plain version's, the bound from this run's table
    # (_gather_bytes_flops) and torch.sparse.mm with the table as CSR (the
    # library call); and their sums over one FB step's gather calls
    from omega_tpu_torch.mesh import carve_mesh, reorder_mesh
    from omega_tpu_torch.ops import gather_kernel, trisk

    GATHER_TOL = {torch.float32: 1e-6, torch.float64: 1e-14}
    t_m = time.perf_counter()
    s48_np = spherical_icos_mesh(N_SPHERE)
    t_r = time.perf_counter()
    g48_np = reorder_mesh(s48_np)
    reorder_s = time.perf_counter() - t_r
    t_w = time.perf_counter()
    trisk.warm_gather(g48_np)
    warm_s = time.perf_counter() - t_w
    gth = {"tolerance": "max|diff| <= 1e-6 max|ref| (float32, icos48 x "
           "100), 1e-14 (float64, icos16 x 8 and x 1) against apply_plain",
           "host_sphere_build_s": t_r - t_m,
           "host_reorder_mesh_s": reorder_s,
           "host_warm_gather_s_of_it": warm_s}

    def gather_check(mesh_np, dtype, Ks, timed=None):
        worst = 0.0
        for name, t in mesh_np.gather_info.items():
            for lead in ((), (2,)):
                for K in Ks:
                    f = rand(lead + (t.nsrc, K), dtype)
                    got = gather_kernel.apply(t, f)
                    ref = gather_kernel.apply_plain(t, f)
                    torch.cuda.synchronize()
                    if got.shape != ref.shape \
                            or not bool(torch.isfinite(got).all()):
                        fail(f"gather {name} {lead} K={K} {dtype}: bad "
                             "output")
                    err = ((got - ref).abs().max()
                           / ref.abs().max().clamp_min(1e-30)).item()
                    if err > GATHER_TOL[dtype]:
                        fail(f"gather {name} {lead} K={K} {dtype}: "
                             f"{err} of max|ref|")
                    worst = max(worst, err)
                    if timed is None:
                        continue
                    L = lead[0] if lead else 1
                    A = _spmm_operand(t.idx[:t.n], t.w[:t.n], t.nsrc, L,
                                      dev, dtype)
                    f2 = f.reshape(-1, K)
                    lib_err = _spmm_check(torch.sparse.mm(A, f2), ref, name)
                    nbytes, flops = _gather_bytes_flops(t, L, K)
                    b_ms, b_by = bound(nbytes, flops)
                    own = cuda_med(lambda: gather_kernel.apply(t, f))
                    lib = cuda_med(lambda: torch.sparse.mm(A, f2))
                    timed[name + ("_L2" if lead else "")] = {
                        "rows": t.n, "slots": t.m, "source_rows": t.nsrc,
                        "window": t.window,
                        "entries": int((t.w[:t.n] != 0).sum()),
                        "max_abs_err": (got - ref).abs().max().item(),
                        "ms": own["ms"], "spread_ms": own["spread_ms"],
                        "plain_ms": cuda_ms(
                            lambda: gather_kernel.apply_plain(t, f), 5),
                        "library_ms": lib["ms"],
                        "library_spread_ms": lib["spread_ms"],
                        "library_rel_err": lib_err, "bytes": nbytes,
                        "bound_ms": b_ms, "bound_by": b_by}
        return worst

    gtab = {}
    gth["f32_icos48_x100"] = gather_check(g48_np, torch.float32, (NLAYERS,),
                                          gtab)
    gth["f64_icos16"] = gather_check(reorder_mesh(spherical_icos_mesh(16)),
                                     torch.float64, (8, 1))
    gth["tables"] = gtab
    # a table wider than the slots a thread holds in registers (20 slots,
    # a third of the weights 0): the kernel's any-width path, float32 (its
    # own generator, so that later phases draw what they drew before)
    rng_w = np.random.default_rng(args.seed + 20)
    ww = rng_w.standard_normal((20000, 20))
    ww[rng_w.random(ww.shape) < 1 / 3] = 0.0
    tw = gather_kernel.GatherTable(rng_w.integers(0, 10000, ww.shape), ww,
                                   10000)
    for lead in ((), (2,)):
        f = torch.as_tensor(
            rng_w.standard_normal(lead + (tw.nsrc, NLAYERS)),
            dtype=torch.float32, device=dev)
        got = gather_kernel.apply(tw, f)
        ref = gather_kernel.apply_plain(tw, f)
        err = ((got - ref).abs().max()
               / ref.abs().max().clamp_min(1e-30)).item()
        if got.shape != ref.shape or not err <= GATHER_TOL[torch.float32]:
            fail(f"gather of 20 slots {lead}: {err} of max|ref|")
        gth[f"wide_rows_20_slots_L{len(lead) + 1}_max_abs_err"] = (
            got - ref).abs().max().item()
    gth["slower_than_library"] = sorted(
        k for k, v in gtab.items() if v["ms"] > v["library_ms"])
    gth["fb_step_calls"] = sum(port_bounds.FB_STEP_GATHERS.values())
    for q in ("ms", "plain_ms", "library_ms", "bound_ms"):
        gth[f"fb_step_{q}"] = sum(
            n * gtab[name + ("_L2" if L == 2 else "")][q]
            for (name, L), n in port_bounds.FB_STEP_GATHERS.items())
    emit({"phase": "kernel_gather", **gth})

    # ------------------------------------------------------- 5. main_path
    # the bench configuration, through the entry points a user calls
    mesh_np = planar_hex_mesh(NX, NY, dc=5000.0, f0=1e-4,
                              bottom_depth=1000.0)
    kx, ky = 2 * np.pi / mesh_np.x_period, 2 * np.pi / mesh_np.y_period
    ssh = np.sin(kx * mesh_np.x_cell) * np.sin(ky * mesh_np.y_cell)
    mesh = mesh_np.to(dtype=torch.float32)        # device=None: the card
    ones = torch.ones((1, NLAYERS), dtype=torch.float32, device=dev)
    state = ModelState(
        h=torch.as_tensor((1000.0 + ssh[:, None]) / NLAYERS,
                          dtype=torch.float32, device=dev) * ones,
        u=torch.zeros((mesh.nedges, NLAYERS), dtype=torch.float32,
                      device=dev),
        tracers=10.0 + torch.zeros((NTRACERS, mesh.ncells, NLAYERS),
                                   dtype=torch.float32, device=dev))

    def content(s):
        h64 = s.h.double()
        return (h64.sum().item(),
                [(h64 * s.tracers[l].double()).sum().item()
                 for l in range(NTRACERS)])

    state0 = state
    vol0, trc0 = content(state)
    nseg, seg = 2, 10
    megastep.launches = megastep.rk_launches = 0
    stencil_kernel.launches = 0
    seg_s = []
    for i in range(nseg):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = run_steps(mesh, cfg, state, i * seg * DT, DT, seg,
                          stepper=forward_backward_step)
        torch.cuda.synchronize()
        seg_s.append(time.perf_counter() - t0)
    main_launches = {"fb_step": megastep.launches,
                     "rk_stage": megastep.rk_launches,
                     "stencil": stencil_kernel.launches}
    for name, x in zip(("h", "u", "tracers"), state):
        want = {"h": (mesh.ncells, NLAYERS), "u": (mesh.nedges, NLAYERS),
                "tracers": (NTRACERS, mesh.ncells, NLAYERS)}[name]
        if tuple(x.shape) != want or x.dtype != torch.float32:
            fail(f"main path: {name} has shape {tuple(x.shape)} {x.dtype}")
        if not bool(torch.isfinite(x).all()):
            fail(f"main path: {name} is not finite")
    vol1, trc1 = content(state)
    vol_drift = abs(vol1 - vol0) / vol0
    trc_drift = max(abs(b - a) / abs(a) for a, b in zip(trc0, trc1))
    umax = state.u.abs().max().item()
    if vol_drift > 1e-5 or trc_drift > 1e-5:
        fail(f"main path: volume drift {vol_drift}, tracer drift {trc_drift}")
    if not 0.0 < umax < 1.0:
        fail(f"main path: max|u| = {umax} (expected radiating waves)")
    if main_launches["fb_step"] != nseg * seg:
        fail(f"main path: fused kernel launched {main_launches['fb_step']} "
             f"times in {nseg * seg} steps")
    if main_launches["stencil"] != 0 or main_launches["rk_stage"] != 0:
        fail(f"main path: other kernels ran inside the fused path: "
             f"{main_launches}")
    ms_step = seg_s[-1] / seg * 1e3
    emit({"phase": "main_path", "config": f"{NX}x{NY}x{NLAYERS}x{NTRACERS} "
          "float32 dc=5000 f0=1e-4 dt=30 visc_del2=1e3 visc_del4=1e9",
          "steps": nseg * seg, "segment_seconds": seg_s,
          "ms_per_step": ms_step,
          "gridpoint_steps_per_s": C * NLAYERS / (ms_step * 1e-3),
          "volume_drift": vol_drift, "tracer_drift": trc_drift,
          "max_abs_u": umax, "launches": main_launches})

    # --------------------------------------------------- 6. composed_path
    # the column free surface (ssh = sum_k h - depth) is not taken by the
    # fused kernels (the split-explicit slice brings its kernels): the
    # composed stepper runs, and every stencil pass goes through the stencil
    # kernel
    cfg_col = bench_cfg(NLAYERS, NTRACERS, ssh_formulation="column")
    if any(megastep.supported(mesh, cfg_col, k) for k in ("fb", "rk2", "rk4")):
        fail("column-ssh configuration unexpectedly taken by a fused kernel")
    nup = 3
    run_steps(mesh, cfg_col, state, 0.0, DT, 1)      # untimed first step
    megastep.launches = megastep.rk_launches = 0
    stencil_kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_steps(mesh, cfg_col, state, 0.0, DT, nup,
                    stepper=forward_backward_step)
    torch.cuda.synchronize()
    up_ms = (time.perf_counter() - t0) / nup * 1e3
    comp_launches = {"fb_step": megastep.launches,
                     "rk_stage": megastep.rk_launches,
                     "stencil": stencil_kernel.launches}
    if not all(bool(torch.isfinite(x).all()) for x in out):
        fail("composed path: non-finite state")
    if comp_launches["stencil"] <= 0 or comp_launches["fb_step"] != 0 \
            or comp_launches["rk_stage"] != 0:
        fail(f"composed path: launches {comp_launches}")
    vol2, trc2 = content(out)
    comp_drift = max([abs(vol2 - vol1) / vol1]
                     + [abs(b - a) / abs(a) for a, b in zip(trc1, trc2)])
    if comp_drift > 1e-5:
        fail(f"composed path: volume / tracer drift {comp_drift}")
    comp_dev = device_ms(lambda: run_steps(mesh, cfg_col, state, 0.0, DT, 2,
                                           stepper=forward_backward_step), 2)
    emit({"phase": "composed_path", "config": "as main_path with "
          "ssh_formulation=column", "steps": nup, "ms_per_step": up_ms,
          "device_ms_per_step": comp_dev["all"],
          "stencil_device_ms_per_step": comp_dev["stencil"],
          "stencil_launches_per_step": comp_launches["stencil"] / nup,
          "drift": comp_drift, "launches": comp_launches})
    del out

    # ---------------------------------------------------- 7. science_path
    # the forward-backward science configuration at full width, nothing cut:
    # wind, quadratic bottom drag, upwind thickness and tracer fluxes, PP81
    # vertical mixing on stratified T/S; one launch of each of the three
    # kernels per step
    cfg_sci = cfg_pp
    sci0 = stratified_state(mesh_np, NLAYERS, torch.float32, 0.01)
    wind_sci = wind_of(mesh_np, torch.float32)

    def counts():
        return {"fb_step": megastep.launches,
                "rk_stage": megastep.rk_launches,
                "pp81_coeffs": vmix_kernel.coeff_launches,
                "vmix_solve": vmix_kernel.solve_launches,
                "stencil": stencil_kernel.launches,
                "split_pre": megastep.split_pre_launches,
                "barotropic": btk.launches,
                "split_post": megastep.split_post_launches,
                "patch_step": patch_megastep.launches,
                "patch_coeffs": patch_megastep.coeff_launches,
                "patch_solve": patch_megastep.solve_launches,
                "patch_fct_a": patch_megastep.fct_a_launches,
                "patch_fct_b": patch_megastep.fct_b_launches,
                "patch_rk": patch_megastep.rk_launches,
                "patch_split_pre": patch_megastep.split_pre_launches,
                "bt_gather": bt_gather.launches,
                "patch_split_post": patch_megastep.split_post_launches,
                "gather": gather_kernel.launches}

    def reset_counts():
        megastep.launches = megastep.rk_launches = 0
        vmix_kernel.coeff_launches = vmix_kernel.solve_launches = 0
        stencil_kernel.launches = 0
        megastep.split_pre_launches = megastep.split_post_launches = 0
        btk.launches = 0
        patch_megastep.launches = 0
        patch_megastep.coeff_launches = patch_megastep.solve_launches = 0
        patch_megastep.fct_a_launches = patch_megastep.fct_b_launches = 0
        patch_megastep.rk_launches = 0
        patch_megastep.split_pre_launches = 0
        patch_megastep.split_post_launches = bt_gather.launches = 0
        gather_kernel.launches = 0

    # the split kernels launch on no path but split_path, the patch kernels
    # on no path but the sphere's, the gather kernel on no path but the
    # gather paths'
    NO_PATCH = {"patch_step": 0, "patch_coeffs": 0, "patch_solve": 0,
                "patch_fct_a": 0, "patch_fct_b": 0, "patch_rk": 0,
                "patch_split_pre": 0, "bt_gather": 0, "patch_split_post": 0,
                "gather": 0}
    NO_SPLIT = {"split_pre": 0, "barotropic": 0, "split_post": 0,
                **NO_PATCH}

    vol0, trc0 = content(sci0)
    nseg, seg = 2, 10
    run_steps(mesh, cfg_sci, sci0, 0.0, DT, 1, wind_stress=wind_sci)  # untimed
    # what packing the wind plane costs: the stress is rotated onto the
    # edges through the stencil kernel, once per segment
    stencil_kernel.launches = 0
    megastep.stack_wind(mesh, cfg_sci, wind_sci, torch.float32)
    pack_stencils = stencil_kernel.launches
    reset_counts()
    sci, sci_s = sci0, []
    for i in range(nseg):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sci = run_steps(mesh, cfg_sci, sci, i * seg * DT, DT, seg,
                        stepper=forward_backward_step, wind_stress=wind_sci)
        torch.cuda.synchronize()
        sci_s.append(time.perf_counter() - t0)
    sci_launches = counts()
    # the stencil kernel ran to pack the wind plane, once per segment, and
    # not once more: no step of the loop launched it
    sci_stencils = sci_launches.pop("stencil")
    if sci_stencils != nseg * pack_stencils:
        fail(f"science path: {sci_stencils} stencil launches in {nseg} "
             f"segments; packing the wind takes {pack_stencils}")
    for name, x in zip(("h", "u", "tracers"), sci):
        if x.dtype != torch.float32 or not bool(torch.isfinite(x).all()):
            fail(f"science path: {name} is not finite float32")
    for name, n in sci_launches.items():
        if n != (0 if name == "rk_stage" or name in NO_SPLIT
                 else nseg * seg):
            fail(f"science path: {name} launched {n} times in "
                 f"{nseg * seg} steps")
    vol1s, trc1s = content(sci)
    sci_vol = abs(vol1s - vol0) / vol0
    sci_trc = max(abs(b - a) / abs(a) for a, b in zip(trc0, trc1s))
    if sci_vol > 1e-5 or sci_trc > 1e-5:
        fail(f"science path: volume drift {sci_vol}, tracer drift {sci_trc}")
    # the same segment without a stress, and without drag: the wind moved
    # the top layer, the drag took energy out of the bottom layer
    calm = run_steps(mesh, cfg_sci, sci0, 0.0, DT, nseg * seg)
    cfg_nodrag = bench_cfg(NLAYERS, NTRACERS, dict(wind_forcing=True),
                           vert_mix=PP81, **UPWIND)
    slip = run_steps(mesh, cfg_nodrag, sci0, 0.0, DT, nseg * seg,
                     wind_stress=wind_sci)
    top_moved = (sci.u[:, 0] - calm.u[:, 0]).abs().max().item()
    below_moved = (sci.u[:, NLAYERS // 2]
                   - calm.u[:, NLAYERS // 2]).abs().max().item()
    ke_bottom = sci.u[:, -1].double().square().sum().item()
    ke_bottom_slip = slip.u[:, -1].double().square().sum().item()
    umax = sci.u.abs().max().item()
    # (about steps * dt * stress / (rho0 * layer thickness) = 6e-3 m/s here)
    wind_dv = nseg * seg * DT * 0.1 / (1026.0 * 1000.0 / NLAYERS)
    if not (top_moved > 0.1 * wind_dv and below_moved < 0.01 * top_moved):
        fail(f"science path: wind moved the top layer by {top_moved}, "
             f"layer {NLAYERS // 2} by {below_moved}")
    if not ke_bottom < ke_bottom_slip * (1.0 - 1e-5):
        fail(f"science path: bottom-layer sum u^2 {ke_bottom} with drag, "
             f"{ke_bottom_slip} without")
    if not 0.0 < umax < 1.0:
        fail(f"science path: max|u| = {umax}")
    sci_ms = sci_s[-1] / seg * 1e3
    emit({"phase": "science_path",
          "config": f"{NX}x{NY}x{NLAYERS}x{NTRACERS} float32 dc=5000 f0=1e-4 "
          "dt=30 visc_del2=1e3 visc_del4=1e9 upwind thickness and tracer "
          "fluxes, wind_forcing, bottom_drag 3e-3, PP81 vmix (T, S = "
          "tracers 0, 1)",
          "steps": nseg * seg, "segment_seconds": sci_s,
          "ms_per_step": sci_ms,
          "gridpoint_steps_per_s": C * NLAYERS / (sci_ms * 1e-3),
          "launches": sci_launches,
          "launches_per_step": {k: v / (nseg * seg)
                                for k, v in sci_launches.items()},
          "stencil_launches_per_segment": pack_stencils,
          "stencil_launches_per_step_in_the_loop":
              (sci_stencils - nseg * pack_stencils) / (nseg * seg),
          "volume_drift": sci_vol, "tracer_drift": sci_trc,
          "max_abs_u": umax, "top_layer_u_moved_by_wind": top_moved,
          "mid_layer_u_moved_by_wind": below_moved,
          "bottom_sum_u2_with_drag": ke_bottom,
          "bottom_sum_u2_without_drag": ke_bottom_slip})
    del calm, slip

    def drive(cfg_p, st, stepper, nseg, seg, wind_stress=None, dt=DT):
        """nseg segments of `seg` steps of `dt` through run_steps: (state,
        seconds per segment, launches)"""
        run_steps(mesh, cfg_p, st, 0.0, dt, 1, stepper=stepper,
                  wind_stress=wind_stress)                    # untimed
        reset_counts()
        secs = []
        for i in range(nseg):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = run_steps(mesh, cfg_p, st, i * seg * dt, dt, seg,
                           stepper=stepper, wind_stress=wind_stress)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        return st, secs, counts()

    def drifts(a, b):
        (v0, t0), (v1, t1) = content(a), content(b)
        return abs(v1 - v0) / v0, max(abs(y - x) / abs(x)
                                      for x, y in zip(t0, t1))

    def finite(name, st):
        for f, x in zip(("h", "u", "tracers"), st):
            if x.dtype != torch.float32 or not bool(torch.isfinite(x).all()):
                fail(f"{name}: {f} is not finite float32")

    def check_launches(name, got, want):
        if got != want:
            fail(f"{name}: launches {got}, expected {want}")

    # -------------------------------------------------------- 8. fct_path
    # the FB step with FCT tracer fluxes, fused: one launch per step; a 0/1
    # step tracer stays in [0, 1] (tracer diffusion off, the reference's
    # form; within 1e-6 at u = 0.05 x noise, MONO_F32 at the reference's
    # 0.5) and the volume and tracer content are conserved
    nseg, seg = 2, 10
    fct0 = step_tracer_state(mesh_np, NLAYERS, torch.float32, 0.05)
    fct, fct_s, fct_launches = drive(cfg_mono, fct0, forward_backward_step,
                                     nseg, seg)
    finite("fct path", fct)
    check_launches("fct path", fct_launches,
                   {"fb_step": nseg * seg, "rk_stage": 0, "pp81_coeffs": 0,
                    "vmix_solve": 0, "stencil": 0, **NO_SPLIT})
    fct_vol, fct_trc = drifts(fct0, fct)
    lo, hi = fct.tracers[0].min().item(), fct.tracers[0].max().item()
    if fct_vol > 1e-5 or fct_trc > 1e-5 or lo < -1e-6 or hi > 1 + 1e-6:
        fail(f"fct path: drift {fct_vol} / {fct_trc}, tracer 0 in "
             f"[{lo}, {hi}]")
    fct_ms = fct_s[-1] / seg * 1e3
    # the same in the reference's ten times stronger flow, held to the
    # float32 limit kernel_fb_step states for it
    ref0 = step_tracer_state(mesh_np, NLAYERS, torch.float32, 0.5)
    ref, _, ref_launches = drive(cfg_mono, ref0, forward_backward_step, 1,
                                 nseg * seg)
    finite("fct path, u = 0.5 x noise", ref)
    check_launches("fct path, u = 0.5 x noise", ref_launches,
                   {"fb_step": nseg * seg, "rk_stage": 0, "pp81_coeffs": 0,
                    "vmix_solve": 0, "stencil": 0, **NO_SPLIT})
    ref_lo, ref_hi = ref.tracers[0].min().item(), ref.tracers[0].max().item()
    if ref_lo < -MONO_F32[0.5] or ref_hi > 1 + MONO_F32[0.5]:
        fail(f"fct path, u = 0.5 x noise: tracer 0 in [{ref_lo}, {ref_hi}]")
    emit({"phase": "fct_path", "config": "as main_path with "
          "flux_tracer_type=fct and eddy_diff2 = eddy_diff4 = 0; tracer 0 a "
          "0/1 step in x, u = 0.05 x noise", "steps": nseg * seg,
          "segment_seconds": fct_s, "ms_per_step": fct_ms,
          "gridpoint_steps_per_s": C * NLAYERS / (fct_ms * 1e-3),
          "launches": fct_launches, "volume_drift": fct_vol,
          "tracer_drift": fct_trc, "tracer0_range": [lo, hi],
          "tracer0_range_u_amp_0.5": [ref_lo, ref_hi]})
    del fct, fct0, ref, ref0

    # -------------------------------------------------------- 9. rk4_path
    # the bench configuration and state with the RK4 stepper: four stage
    # launches per step and nothing else
    rk4, rk4_s, rk4_launches = drive(cfg, state0, rk4_step, nseg, seg)
    finite("rk4 path", rk4)
    check_launches("rk4 path", rk4_launches,
                   {"fb_step": 0, "rk_stage": 4 * nseg * seg,
                    "pp81_coeffs": 0, "vmix_solve": 0, "stencil": 0,
                    **NO_SPLIT})
    rk4_vol, rk4_trc = drifts(state0, rk4)
    rk4_umax = rk4.u.abs().max().item()
    if rk4_vol > 1e-5 or rk4_trc > 1e-5 or not 0.0 < rk4_umax < 1.0:
        fail(f"rk4 path: drift {rk4_vol} / {rk4_trc}, max|u| {rk4_umax}")
    rk4_ms = rk4_s[-1] / seg * 1e3
    emit({"phase": "rk4_path", "config": "as main_path, stepper=rk4_step",
          "steps": nseg * seg, "segment_seconds": rk4_s,
          "ms_per_step": rk4_ms,
          "gridpoint_steps_per_s": C * NLAYERS / (rk4_ms * 1e-3),
          "launches": rk4_launches,
          "launches_per_step": {k: v / (nseg * seg)
                                for k, v in rk4_launches.items()},
          "volume_drift": rk4_vol, "tracer_drift": rk4_trc,
          "max_abs_u": rk4_umax})
    del rk4

    # -------------------------------------------------------- 10. rk2_path
    # the science configuration with the RK2 stepper: two stage launches,
    # then the coefficient and solve kernels, per step; the wind plane is
    # packed once per segment
    rk2, rk2_s, rk2_launches = drive(cfg_sci, sci0, rk2_step, nseg, seg,
                                     wind_sci)
    finite("rk2 path", rk2)
    check_launches("rk2 path", rk2_launches,
                   {"fb_step": 0, "rk_stage": 2 * nseg * seg,
                    "pp81_coeffs": nseg * seg, "vmix_solve": nseg * seg,
                    "stencil": nseg * pack_stencils, **NO_SPLIT})
    rk2_vol, rk2_trc = drifts(sci0, rk2)
    calm = run_steps(mesh, cfg_sci, sci0, 0.0, DT, nseg * seg,
                     stepper=rk2_step)
    rk2_top = (rk2.u[:, 0] - calm.u[:, 0]).abs().max().item()
    rk2_mid = (rk2.u[:, NLAYERS // 2]
               - calm.u[:, NLAYERS // 2]).abs().max().item()
    rk2_umax = rk2.u.abs().max().item()
    if rk2_vol > 1e-5 or rk2_trc > 1e-5 or not 0.0 < rk2_umax < 1.0:
        fail(f"rk2 path: drift {rk2_vol} / {rk2_trc}, max|u| {rk2_umax}")
    if not (rk2_top > 0.1 * wind_dv and rk2_mid < 0.01 * rk2_top):
        fail(f"rk2 path: wind moved the top layer by {rk2_top}, layer "
             f"{NLAYERS // 2} by {rk2_mid}")
    rk2_ms = rk2_s[-1] / seg * 1e3
    emit({"phase": "rk2_path", "config": "as science_path, "
          "stepper=rk2_step", "steps": nseg * seg, "segment_seconds": rk2_s,
          "ms_per_step": rk2_ms,
          "gridpoint_steps_per_s": C * NLAYERS / (rk2_ms * 1e-3),
          "launches": rk2_launches,
          "launches_per_step_in_the_loop": {
              k: (v - (nseg * pack_stencils if k == "stencil" else 0))
              / (nseg * seg) for k, v in rk2_launches.items()},
          "volume_drift": rk2_vol, "tracer_drift": rk2_trc,
          "max_abs_u": rk2_umax, "top_layer_u_moved_by_wind": rk2_top,
          "mid_layer_u_moved_by_wind": rk2_mid})
    del rk2, calm

    # ----------------------------------------------------- 10b. split_path
    # the split-explicit stepper on the bench configuration with the column
    # free surface, at four times main_path's dt with M = 10 barotropic
    # subcycles, through make_stepper("SplitExplicit"): splitpre (two
    # launches), one subcycle launch and splitpost per step, nothing else
    cfg_split = bench_cfg(NLAYERS, NTRACERS, ssh_formulation="column")
    split_stepper = make_stepper("SplitExplicit")
    if split_stepper.split_explicit_params != (M_SPLIT, 0.0):
        fail(f"SplitExplicit runs {split_stepper.split_explicit_params}")
    spl_st, spl_s, spl_launches = drive(cfg_split, state0, split_stepper,
                                        nseg, seg, dt=DT_SPLIT)
    finite("split path", spl_st)
    check_launches("split path", spl_launches,
                   {"fb_step": 0, "rk_stage": 0, "pp81_coeffs": 0,
                    "vmix_solve": 0, "stencil": 0,
                    "split_pre": megastep.SPLIT_PRE_PASSES * nseg * seg,
                    "barotropic": nseg * seg,
                    "split_post": nseg * seg, **NO_PATCH})
    spl_vol, spl_trc = drifts(state0, spl_st)
    spl_umax = spl_st.u.abs().max().item()
    if spl_vol > 1e-5 or spl_trc > 1e-5 or not 0.0 < spl_umax < 1.0:
        fail(f"split path: drift {spl_vol} / {spl_trc}, max|u| {spl_umax}")
    spl_ms = spl_s[-1] / seg * 1e3
    emit({"phase": "split_path", "config": "as main_path with "
          f"ssh_formulation=column, stepper SplitExplicit (M = {M_SPLIT}, "
          f"bt_drag = 0), dt = {DT_SPLIT}", "steps": nseg * seg,
          "segment_seconds": spl_s, "ms_per_step": spl_ms,
          "gridpoint_steps_per_s": C * NLAYERS / (spl_ms * 1e-3),
          "simulated_s_per_wall_s": DT_SPLIT / (spl_ms * 1e-3),
          "main_path_simulated_s_per_wall_s": DT / (ms_step * 1e-3),
          "launches": spl_launches,
          "launches_per_step": {k: v / (nseg * seg)
                                for k, v in spl_launches.items()},
          "volume_drift": spl_vol, "tracer_drift": spl_trc,
          "max_abs_u": spl_umax})
    del spl_st

    # ------------------------------------------- 10b2. split_science_path
    # the split-explicit stepper (M = 10, dt = 120 s) with the science
    # configuration (upwind fluxes, wind, drag 3e-3, PP81 on stratified T
    # and S) and the column free surface: the fused split kernels decline
    # it (megastep.split_supported), so it runs composed, every stencil
    # pass through the stencil kernel and the subcycles through the planar
    # barotropic kernel (stepping/split.subcycle_route), no fused kernel
    cfg_ssp = bench_cfg(NLAYERS, NTRACERS, WIND_DRAG, vert_mix=PP81,
                        ssh_formulation="column", **UPWIND)
    if megastep.split_supported(mesh, cfg_ssp):
        fail("split science configuration taken by the fused split kernels")
    ssp, ssp_s, ssp_launches = drive(cfg_ssp, sci0, split_stepper, nseg, seg,
                                     wind_sci, dt=DT_SPLIT)
    finite("split science path", ssp)
    nst = nseg * seg
    fused_zero = {k: 0 for k in ("fb_step", "rk_stage", "split_pre",
                                 "split_post", *NO_PATCH)}
    if {k: ssp_launches[k] for k in fused_zero} != fused_zero \
            or ssp_launches["barotropic"] != nst \
            or ssp_launches["stencil"] <= 0 \
            or ssp_launches["stencil"] % nst:
        fail(f"split science path: launches {ssp_launches} in {nst} steps")
    ssp_vol, ssp_trc = drifts(sci0, ssp)
    if ssp_vol > 1e-5 or ssp_trc > 1e-5:
        fail(f"split science path: drift {ssp_vol} / {ssp_trc}")
    # without the stress, and without drag: the wind moved the top layer
    # (the layer below it by the barotropic share, about 1/K of it, and
    # what the mixing carries down), the drag took energy out of the bottom
    calm = run_steps(mesh, cfg_ssp, sci0, 0.0, DT_SPLIT, nst,
                     stepper=split_stepper)
    slip = run_steps(mesh, bench_cfg(NLAYERS, NTRACERS,
                                     dict(wind_forcing=True), vert_mix=PP81,
                                     ssh_formulation="column", **UPWIND),
                     sci0, 0.0, DT_SPLIT, nst, stepper=split_stepper,
                     wind_stress=wind_sci)
    ssp_top = (ssp.u[:, 0] - calm.u[:, 0]).abs().max().item()
    ssp_mid = (ssp.u[:, NLAYERS // 2]
               - calm.u[:, NLAYERS // 2]).abs().max().item()
    ssp_ke = ssp.u[:, -1].double().square().sum().item()
    ssp_ke_slip = slip.u[:, -1].double().square().sum().item()
    ssp_umax = ssp.u.abs().max().item()
    ssp_dv = nst * DT_SPLIT * 0.1 / (1026.0 * 1000.0 / NLAYERS)
    if not (ssp_top > 0.1 * ssp_dv and ssp_mid < 0.1 * ssp_top):
        fail(f"split science path: wind moved the top layer by {ssp_top}, "
             f"layer {NLAYERS // 2} by {ssp_mid}")
    if not ssp_ke < ssp_ke_slip * (1.0 - 1e-5):
        fail(f"split science path: bottom-layer sum u^2 {ssp_ke} with "
             f"drag, {ssp_ke_slip} without")
    if not 0.0 < ssp_umax < 1.0:
        fail(f"split science path: max|u| = {ssp_umax}")
    ssp_ms = ssp_s[-1] / seg * 1e3
    ssp_dev = device_ms(lambda: run_steps(
        mesh, cfg_ssp, ssp, 0.0, DT_SPLIT, 2, stepper=split_stepper,
        wind_stress=wind_sci), 2)
    emit({"phase": "split_science_path",
          "config": "as science_path with ssh_formulation=column, stepper "
          f"SplitExplicit (M = {M_SPLIT}, bt_drag = 0), dt = {DT_SPLIT}: "
          "composed, subcycles in the barotropic kernel",
          "steps": nst, "segment_seconds": ssp_s, "ms_per_step": ssp_ms,
          "device_ms_per_step": ssp_dev["all"],
          "stencil_device_ms_per_step": ssp_dev["stencil"],
          "gridpoint_steps_per_s": C * NLAYERS / (ssp_ms * 1e-3),
          "launches": ssp_launches,
          "launches_per_step": {k: v / nst for k, v in ssp_launches.items()},
          "volume_drift": ssp_vol, "tracer_drift": ssp_trc,
          "max_abs_u": ssp_umax, "top_layer_u_moved_by_wind": ssp_top,
          "mid_layer_u_moved_by_wind": ssp_mid,
          "bottom_sum_u2_with_drag": ssp_ke,
          "bottom_sum_u2_without_drag": ssp_ke_slip})
    del ssp, calm, slip

    # ---------------------------------------------------- 10c. sphere_path
    # bench.py's sphere configuration (icos48 x 100 layers x 2 tracers,
    # float32, dt = 30 s) through run_steps with u = 0.01 x noise x
    # edge_mask: the frames are the loop's carry, a step is one call of the
    # patch step (six launches), the pole submesh's composed step and the
    # in-frame refresh; no other kernel launches
    def sphere_content(st):
        a = torch.as_tensor(np.asarray(m48_np.area_cell), device=dev)[:, None]
        h64 = st.h.double()
        return ((a * h64).sum().item(),
                [(a * h64 * st.tracers[l].double()).sum().item()
                 for l in range(NTRACERS)])

    sph0 = sphere_state(m48_np, NLAYERS, NTRACERS, torch.float32, 0.01, 0.0)
    run_steps(m48, cfg48, sph0, 0.0, DT, 1)                   # untimed
    reset_counts()
    sph, sph_s = sph0, []
    for i in range(nseg):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sph = run_steps(m48, cfg48, sph, i * seg * DT, DT, seg,
                        stepper=forward_backward_step)
        torch.cuda.synchronize()
        sph_s.append(time.perf_counter() - t0)
    sph_launches = counts()
    finite("sphere path", sph)
    check_launches("sphere path", sph_launches,
                   {"fb_step": 0, "rk_stage": 0, "pp81_coeffs": 0,
                    "vmix_solve": 0, "stencil": 0, "split_pre": 0,
                    "barotropic": 0, "split_post": 0,
                    **NO_PATCH,
                    "patch_step": patch_megastep.PASSES * nseg * seg})
    (v0, t0_), (v1, t1_) = sphere_content(sph0), sphere_content(sph)
    sph_vol = abs(v1 - v0) / v0
    sph_trc = max(abs(b - a) / abs(a) for a, b in zip(t0_, t1_))
    sph_umax = sph.u.abs().max().item()
    dead = torch.as_tensor(np.asarray(m48_np.edge_mask) == 0, device=dev)
    sph_dead = sph.u[dead].abs().max().item() if bool(dead.any()) else 0.0
    if sph_vol > 1e-5 or sph_trc > 1e-5 or not 0.0 < sph_umax < 1.0:
        fail(f"sphere path: drift {sph_vol} / {sph_trc}, max|u| {sph_umax}")
    if sph_dead != 0.0:
        fail(f"sphere path: u on dead edges reaches {sph_dead}")
    sph_ms = sph_s[-1] / seg * 1e3
    real_cells = m48_np.ncells
    emit({"phase": "sphere_path", "config": f"icos{N_SPHERE} "
          f"({real_cells} cells) x {NLAYERS} x {NTRACERS} float32, "
          "bottom_depth 4000, h = (depth + sin 2 lat cos lon) / K, tracers "
          "10, u = 0.01 x noise x edge_mask, dt=30 visc_del2=1e3 "
          "visc_del4=1e9; margin 8, worst-case validity masks",
          "host_mesh_build_s": sphere_build_s, "steps": nseg * seg,
          "segment_seconds": sph_s, "ms_per_step": sph_ms,
          "gridpoint_steps_per_s": real_cells * NLAYERS / (sph_ms * 1e-3),
          "launches": sph_launches,
          "launches_per_step": {k: v / (nseg * seg)
                                for k, v in sph_launches.items()},
          "volume_drift": sph_vol, "tracer_drift": sph_trc,
          "max_abs_u": sph_umax, "max_abs_u_dead_edges": sph_dead,
          "breakdown_ms": {"patch_step": patv["ms"],
                           "submesh_step": patv["submesh_step_ms"],
                           "refresh": patv["refresh_ms"]}})

    # -------------------------------------------- 10d. sphere_science_path
    # the Omega-1 science configuration on bench.py's sphere (icos48 x 100
    # x 2, float32, dt = 30 s): upwind thickness and tracer fluxes, a wind
    # stress varying with latitude, bottom drag 3e-3, PP81 mixing on a
    # stratified T / S, through run_steps with the stress. A step is one
    # call of the patch step's science variant (six launches), the PP81
    # coefficient kernel, the column solve, the pole submesh's composed
    # step and the refresh; no other kernel launches
    cfg_ss = cfg48s
    ss0 = sphere_strat(m48_np, NLAYERS, torch.float32, 0.01)
    run_steps(m48, cfg_ss, ss0, 0.0, DT, 1, wind_stress=w48)     # untimed
    reset_counts()
    ss, ss_s = ss0, []
    for i in range(nseg):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ss = run_steps(m48, cfg_ss, ss, i * seg * DT, DT, seg,
                       stepper=forward_backward_step, wind_stress=w48)
        torch.cuda.synchronize()
        ss_s.append(time.perf_counter() - t0)
    ss_launches = counts()
    finite("sphere science path", ss)
    check_launches("sphere science path", ss_launches,
                   {"fb_step": 0, "rk_stage": 0, "pp81_coeffs": 0,
                    "vmix_solve": 0, "stencil": 0, "split_pre": 0,
                    "barotropic": 0, "split_post": 0,
                    **NO_PATCH,
                    "patch_step": patch_megastep.PASSES * nseg * seg,
                    "patch_coeffs": nseg * seg, "patch_solve": nseg * seg})
    (v0, t0_), (v1, t1_) = sphere_content(ss0), sphere_content(ss)
    ss_vol = abs(v1 - v0) / v0
    ss_trc = max(abs(b - a) / abs(a) for a, b in zip(t0_, t1_))
    ss_umax = ss.u.abs().max().item()
    ss_dead = ss.u[dead].abs().max().item() if bool(dead.any()) else 0.0
    if ss_vol > 1e-5 or ss_trc > 1e-5 or not 0.0 < ss_umax < 1.0:
        fail(f"sphere science path: drift {ss_vol} / {ss_trc}, max|u| "
             f"{ss_umax}")
    if ss_dead != 0.0:
        fail(f"sphere science path: u on dead edges reaches {ss_dead}")
    # the same steps without a stress, and without drag: the wind moved the
    # top layer, the drag took energy out of the bottom layer
    calm = run_steps(m48, cfg_ss, ss0, 0.0, DT, nseg * seg)
    slip = run_steps(m48, bench_cfg(NLAYERS, NTRACERS,
                                    dict(wind_forcing=True), vert_mix=PP81,
                                    **UPWIND),
                     ss0, 0.0, DT, nseg * seg, wind_stress=w48)
    ss_top = (ss.u[:, 0] - calm.u[:, 0]).abs().max().item()
    ss_mid = (ss.u[:, NLAYERS // 2]
              - calm.u[:, NLAYERS // 2]).abs().max().item()
    ss_ke = ss.u[:, -1].double().square().sum().item()
    ss_ke_slip = slip.u[:, -1].double().square().sum().item()
    # (about steps * dt * stress / (rho0 * layer thickness) = 1.5e-3 m/s)
    ss_dv = nseg * seg * DT * 0.1 / (1026.0 * 4000.0 / NLAYERS)
    if not (ss_top > 0.1 * ss_dv and ss_mid < 0.01 * ss_top):
        fail(f"sphere science path: wind moved the top layer by {ss_top}, "
             f"layer {NLAYERS // 2} by {ss_mid}")
    if not ss_ke < ss_ke_slip * (1.0 - 1e-5):
        fail(f"sphere science path: bottom-layer sum u^2 {ss_ke} with drag, "
             f"{ss_ke_slip} without")
    del calm, slip
    ss_ms = ss_s[-1] / seg * 1e3
    emit({"phase": "sphere_science_path", "config": f"icos{N_SPHERE} "
          f"({real_cells} cells) x {NLAYERS} x {NTRACERS} float32, "
          "bottom_depth 4000, h = (depth + sin 2 lat cos lon) / K, T "
          "decreasing downward + 0.1 noise, S 35 + 0.1 noise, u = 0.01 x "
          "noise x edge_mask, dt=30 visc_del2=1e3 visc_del4=1e9, upwind "
          "thickness and tracer fluxes, wind (0.1 cos lat, 0.05 sin lat), "
          "bottom_drag 3e-3, PP81 vmix (T, S = tracers 0, 1); margin 8, "
          "worst-case validity masks",
          "steps": nseg * seg, "segment_seconds": ss_s, "ms_per_step": ss_ms,
          "gridpoint_steps_per_s": real_cells * NLAYERS / (ss_ms * 1e-3),
          "launches": ss_launches,
          "launches_per_step": {k: v / (nseg * seg)
                                for k, v in ss_launches.items()},
          "volume_drift": ss_vol, "tracer_drift": ss_trc,
          "max_abs_u": ss_umax, "max_abs_u_dead_edges": ss_dead,
          "top_layer_u_moved_by_wind": ss_top,
          "mid_layer_u_moved_by_wind": ss_mid,
          "bottom_sum_u2_with_drag": ss_ke,
          "bottom_sum_u2_without_drag": ss_ke_slip,
          "breakdown_ms": {"patch_step": sciv["step_ms"],
                           "pp81_coeffs": sciv["coeffs_ms"],
                           "column_solve": sciv["solve_ms"]["pp81"],
                           "submesh_step": sciv["submesh_step_ms"],
                           "refresh": sciv["refresh_ms"]}})

    # ----------------------------------------------- 10e. sphere_fct_path
    # Zalesak FCT on bench.py's sphere (icos48 x 100 x 2, float32, dt =
    # 30 s, flagship terms, center thickness flux), tracer diffusion off
    # (eddy_diff2 = eddy_diff4 = 0, its flags on): a 0/1 spherical cap in
    # tracer 0, u = 0.05 x noise x edge_mask, through run_steps. A step is
    # stage A (six launches), the refresh of its fields, stage B (four
    # launches), the FCT fix submesh's composed stages and the final
    # refresh; no other kernel launches. The cap stays in [0, 1] within
    # MONO_F32 (the planar limits), at u = 0.05 and at the reference's 0.5
    sf0 = sphere_fct_state(m48_np, NLAYERS, torch.float32, 0.05)
    run_steps(m48, cfg_sf, sf0, 0.0, DT, 1)                     # untimed
    want_sf = {"fb_step": 0, "rk_stage": 0, "pp81_coeffs": 0,
               "vmix_solve": 0, "stencil": 0, "split_pre": 0,
               "barotropic": 0, "split_post": 0, **NO_PATCH,
               "patch_fct_a": patch_megastep.PASSES * nseg * seg,
               "patch_fct_b": patch_megastep.FCT_B_PASSES * nseg * seg}
    reset_counts()
    sf, sf_s = sf0, []
    for i in range(nseg):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sf = run_steps(m48, cfg_sf, sf, i * seg * DT, DT, seg,
                       stepper=forward_backward_step)
        torch.cuda.synchronize()
        sf_s.append(time.perf_counter() - t0)
    sf_launches = counts()
    finite("sphere fct path", sf)
    check_launches("sphere fct path", sf_launches, want_sf)
    (v0, t0_), (v1, t1_) = sphere_content(sf0), sphere_content(sf)
    sf_vol = abs(v1 - v0) / v0
    sf_trc = max(abs(b - a) / abs(a) for a, b in zip(t0_, t1_))
    sf_lo, sf_hi = sf.tracers[0].min().item(), sf.tracers[0].max().item()
    # (a cap edge moves by about u dt / dc, 1e-4 of a cell here)
    sf_between = ((sf.tracers[0] > 1e-6) & (sf.tracers[0] < 1 - 1e-6)).sum()
    if sf_vol > 1e-5 or sf_trc > 1e-5 or sf_lo < -MONO_F32[0.05] \
            or sf_hi > 1 + MONO_F32[0.05] or int(sf_between) == 0:
        fail(f"sphere fct path: drift {sf_vol} / {sf_trc}, tracer 0 in "
             f"[{sf_lo}, {sf_hi}], {int(sf_between)} points inside")
    sf05 = sphere_fct_state(m48_np, NLAYERS, torch.float32, 0.5)
    reset_counts()
    sf05 = run_steps(m48, cfg_sf, sf05, 0.0, DT, nseg * seg)
    finite("sphere fct path, u = 0.5 x noise", sf05)
    check_launches("sphere fct path, u = 0.5 x noise", counts(), want_sf)
    sf05_lo = sf05.tracers[0].min().item()
    sf05_hi = sf05.tracers[0].max().item()
    if sf05_lo < -MONO_F32[0.5] or sf05_hi > 1 + MONO_F32[0.5]:
        fail(f"sphere fct path, u = 0.5 x noise: tracer 0 in [{sf05_lo}, "
             f"{sf05_hi}]")
    sf_ms = sf_s[-1] / seg * 1e3
    emit({"phase": "sphere_fct_path", "config": f"icos{N_SPHERE} "
          f"({real_cells} cells) x {NLAYERS} x {NTRACERS} float32, "
          "bottom_depth 4000, h = (depth + sin 2 lat cos lon) / K, tracer 0 "
          "a 0/1 cap (cos lat cos lon > 0.7), tracer 1 10, u = 0.05 x noise "
          "x edge_mask, dt=30 visc_del2=1e3 visc_del4=1e9, flux_tracer_type="
          "fct, eddy_diff2 = eddy_diff4 = 0; margin 8",
          "steps": nseg * seg, "segment_seconds": sf_s, "ms_per_step": sf_ms,
          "gridpoint_steps_per_s": real_cells * NLAYERS / (sf_ms * 1e-3),
          "launches": sf_launches,
          "launches_per_step": {k: v / (nseg * seg)
                                for k, v in sf_launches.items()},
          "volume_drift": sf_vol, "tracer_drift": sf_trc,
          "tracer0_range": [sf_lo, sf_hi],
          "tracer0_points_strictly_between": int(sf_between),
          "tracer0_range_u_amp_0.5": [sf05_lo, sf05_hi],
          "range_limits": MONO_F32,
          "breakdown_ms": {"stage_a": fcv["stage_a_ms"],
                           "stage_b": fcv["stage_b_ms"],
                           "submesh_step": fcv["submesh_step_ms"],
                           "mid_refresh": fcv["mid_refresh_ms"],
                           "final_refresh": fcv["final_refresh_ms"],
                           "framed_step": fcv["step_ms"]}})
    del sf, sf05

    # ---------------------------------------- 10f. sphere_rk4_path / rk2
    # bench.py's sphere (icos48 x 100 x 2, float32, dt = 30 s) with the RK4
    # stepper and flagship terms (sphere_path's state), and with the RK2
    # stepper and the science configuration (sphere_science_path's state
    # and stress), through run_steps. A step is per stage one call of the
    # RK stage kernel (four launches), the pole submesh's tendencies and
    # the refresh (RK4: of the provisional frames and the accumulator), then
    # with mixing the PP81 coefficient kernel and the column solve; no
    # other kernel launches
    def sphere_run(name, cfg_p, st, stepper, want, wind_stress=None,
                   dt=DT):
        run_steps(m48, cfg_p, st, 0.0, dt, 1, stepper=stepper,
                  wind_stress=wind_stress)                      # untimed
        reset_counts()
        out, secs = st, []
        for i in range(nseg):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run_steps(m48, cfg_p, out, i * seg * dt, dt, seg,
                            stepper=stepper, wind_stress=wind_stress)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        got = counts()
        finite(name, out)
        check_launches(name, got, want)
        (v0, t0_), (v1, t1_) = sphere_content(st), sphere_content(out)
        vol = abs(v1 - v0) / v0
        trc = max(abs(b - a) / abs(a) for a, b in zip(t0_, t1_))
        umax = out.u.abs().max().item()
        udead = out.u[dead].abs().max().item() if bool(dead.any()) else 0.0
        if vol > 1e-5 or trc > 1e-5 or not 0.0 < umax < 1.0 or udead != 0.0:
            fail(f"{name}: drift {vol} / {trc}, max|u| {umax}, u on dead "
                 f"edges {udead}")
        ms = secs[-1] / seg * 1e3
        return out, {
            "steps": nseg * seg, "segment_seconds": secs, "ms_per_step": ms,
            "gridpoint_steps_per_s": real_cells * NLAYERS / (ms * 1e-3),
            "launches": got,
            "launches_per_step": {k: v / (nseg * seg) for k, v in got.items()},
            "volume_drift": vol, "tracer_drift": trc, "max_abs_u": umax,
            "max_abs_u_dead_edges": udead}

    none = {"fb_step": 0, "rk_stage": 0, "pp81_coeffs": 0, "vmix_solve": 0,
            "stencil": 0, "split_pre": 0, "barotropic": 0, "split_post": 0,
            **NO_PATCH}
    rk4s, rec = sphere_run(
        "sphere rk4 path", cfg48, sph0, rk4_step,
        {**none, "patch_rk": 4 * patch_megastep.RK_PASSES * nseg * seg})
    rk4s_launches = rec["launches"]
    cc = rkpv["cc"]
    emit({"phase": "sphere_rk4_path", "config": f"as sphere_path, "
          "stepper=rk4_step", **rec,
          "breakdown_ms": {
              "rk_stages": rkpv["rk4_stages_ms"],
              "submesh_tendencies": 4 * cc["submesh_tendencies_ms"],
              "refresh": 7 * cc["refresh_ms"],
              "per_stage": {c: cc[c]["ms"] for c in ("first", "mid",
                                                     "last")}},
          "breakdown_note": "per step: the four stages' kernel times, four "
          "submesh tendency evaluations, seven refreshes (provisional and "
          "accumulator after stages 1-3, the state after stage 4)"})
    del rk4s
    rk2s, rec = sphere_run(
        "sphere rk2 path", cfg_ss, ss0, rk2_step,
        {**none, "patch_rk": 2 * patch_megastep.RK_PASSES * nseg * seg,
         "patch_coeffs": nseg * seg, "patch_solve": nseg * seg},
        wind_stress=w48)
    rk2s_launches = rec["launches"]
    uw = rkpv["uu_wind_drag"]
    emit({"phase": "sphere_rk2_path", "config": "as sphere_science_path, "
          "stepper=rk2_step", **rec,
          "breakdown_ms": {
              "rk_stages": rkpv["rk2_science_stages_ms"],
              "pp81_coeffs": sciv["coeffs_ms"],
              "column_solve": sciv["solve_ms"]["pp81"],
              "submesh_tendencies": 2 * uw["submesh_tendencies_ms"],
              "refresh": 2 * uw["refresh_ms"]},
          "breakdown_note": "per step: the two stages' kernel times, the "
          "column kernels, two submesh tendency evaluations (the submesh's "
          "vertical mixing not counted), two refreshes"})
    del rk2s

    # ------------------------------------------- 10g. sphere_split_path
    # the split-explicit stepper on bench.py's sphere with the column free
    # surface (icos48 x 100 x 2, float32, dt = 120 s, M = 10, bt_drag 0:
    # the reference's `sphere-split` item, scripts/tpu_r3_item.py:172-178)
    # through run_steps with split_forward_backward_step. A step is splitpre
    # (five launches), the flat 2-D phase with the subcycles (one
    # launch), splitpost (four launches), the pole submesh's composed part and
    # the refresh; no other kernel launches. First the composed split
    # stepper over two steps, for comparison
    sp0 = sphere_state(m48_np, NLAYERS, NTRACERS, torch.float32, 0.01, 0.0)
    composed(split_forward_backward_step, m48, cfg48p, sp0, 0.0, DT_SPLIT)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    comp = sp0
    for i in range(2):
        comp = composed(split_forward_backward_step, m48, cfg48p, comp,
                        i * DT_SPLIT, DT_SPLIT)
    torch.cuda.synchronize()
    comp_ms = (time.perf_counter() - t0) / 2 * 1e3
    finite("sphere split composed", comp)
    emit({"phase": "sphere_split_composed", "config": "as "
          "sphere_split_path, the composed split stepper (patch operators, "
          "the subcycles' plain loop)", "steps": 2, "ms_per_step": comp_ms,
          "launches": counts()})
    del comp
    sps, rec = sphere_run(
        "sphere split path", cfg48p, sp0, split_forward_backward_step,
        {**none,
         "patch_split_pre": patch_megastep.SPLIT_PRE_PASSES * nseg * seg,
         "bt_gather": nseg * seg,
         "patch_split_post": patch_megastep.SPLIT_POST_PASSES * nseg * seg},
        dt=DT_SPLIT)
    sps_launches = rec["launches"]
    emit({"phase": "sphere_split_path", "config": "as sphere_path with "
          "ssh_formulation=column, tracers 10, stepper "
          f"split_forward_backward_step (M = {M_SPLIT}, bt_drag = 0), dt = "
          f"{DT_SPLIT}", **rec,
          "simulated_s_per_wall_s": DT_SPLIT / (rec["ms_per_step"] * 1e-3),
          "sphere_path_simulated_s_per_wall_s": DT / (sph_ms * 1e-3),
          "composed_ms_per_step": comp_ms,
          "breakdown_ms": {"split_pre": sptv["split_pre_ms"],
                           "subcycles": sptv["bt_ms"],
                           "split_post": sptv["split_post_ms"],
                           "submesh": sptv["submesh_ms"],
                           "refresh": sptv["refresh_ms"],
                           "framed_step": sptv["step_ms"],
                           "rest": sptv["step_rest_ms"]},
          "breakdown_note": "per step, by CUDA events (kernel_patch_split): "
          "splitpre, the M subcycles, splitpost, the pole submesh's "
          "tendency and advance, the refresh; `rest` the framed step less "
          "those (the read-out, the flat phase's composed operators, the "
          "frames of u_trans and u_new)"})
    del sps

    # ------------------------------------------------------ 10h. gather_path
    # bench.py's sphere with OMEGA_PATCHES=0 (bench.py:77-92): the
    # RCM-renumbered icos48 with its gather tables (kernel_gather's
    # g48_np), sphere_path's state and configuration (x 100 x 2, float32,
    # dt = 30 s), 2 x 10 FB steps through run_steps on a CUDA state: the
    # composed step, in which every TRiSK operator that has a table is one
    # launch of the gather kernel and no index_select; then, as
    # information, the same steps with the tables stripped
    # (gather_info=None: the index_select route)
    def gather_run(name, mesh_np):
        g = mesh_np.to(dev, torch.float32)
        st0 = sphere_state(mesh_np, NLAYERS, NTRACERS, torch.float32, 0.01,
                           0.0)
        area = torch.as_tensor(np.asarray(mesh_np.area_cell),
                               device=dev)[:, None]

        def cont(st):
            h64 = st.h.double()
            return ((area * h64).sum().item(),
                    [(area * h64 * st.tracers[l].double()).sum().item()
                     for l in range(NTRACERS)])

        def segments(m, n):
            out, secs = st0, []
            for i in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = run_steps(m, cfg48, out, i * seg * DT, DT, seg,
                                stepper=forward_backward_step)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            return out, secs

        reset_counts()
        trisk.take_launches = 0
        run_steps(g, cfg48, st0, 0.0, DT, 1)                     # untimed
        per_step = gather_kernel.launches
        if per_step <= 0 or trisk.take_launches != 0:
            fail(f"{name}: a step made {per_step} gather launches and "
                 f"{trisk.take_launches} index_select launches")
        reset_counts()
        out, secs = segments(g, nseg)
        got, takes = counts(), trisk.take_launches
        finite(name, out)
        check_launches(name, got, {**none, "gather": per_step * nseg * seg})
        if takes != 0:
            fail(f"{name}: {takes} index_select launches in operators with "
                 "a table")
        (v0, t0_), (v1, t1_) = cont(st0), cont(out)
        vol = abs(v1 - v0) / v0
        trc = max(abs(b - a) / abs(a) for a, b in zip(t0_, t1_))
        umax = out.u.abs().max().item()
        coast = torch.as_tensor(np.asarray(mesh_np.edge_mask) == 0,
                                device=dev)
        ucoast = out.u[coast].abs().max().item() if bool(coast.any()) \
            else 0.0
        if vol > 1e-5 or trc > 1e-5 or not 0.0 < umax < 1.0 \
                or ucoast != 0.0:
            fail(f"{name}: drift {vol} / {trc}, max|u| {umax}, u on the "
                 f"coast {ucoast}")
        ms = secs[-1] / seg * 1e3
        # the index_select route, as information
        bare = dataclasses.replace(g, gather_info=None)
        run_steps(bare, cfg48, st0, 0.0, DT, 1)                  # untimed
        trisk.take_launches = 0
        bare_out, bare_secs = segments(bare, nseg)
        bare_ms = bare_secs[-1] / seg * 1e3
        bare_diff = max((a - b).abs().max().item() / b.abs().max().item()
                        for a, b in zip(out, bare_out))
        rec = {"cells": mesh_np.ncells, "edges": mesh_np.nedges,
               "steps": nseg * seg, "segment_seconds": secs,
               "ms_per_step": ms,
               "gridpoint_steps_per_s": mesh_np.ncells * NLAYERS
               / (ms * 1e-3),
               "simulated_s_per_wall_s": DT / (ms * 1e-3),
               "sphere_path_simulated_s_per_wall_s": DT / (sph_ms * 1e-3),
               "launches": got, "gather_launches_per_step": per_step,
               "index_select_launches_in_table_operators": takes,
               "volume_drift": vol, "tracer_drift": trc, "max_abs_u": umax,
               "max_abs_u_coast": ucoast,
               "coast_edges": int(coast.sum().item()),
               "index_select_route": {
                   "ms_per_step": bare_ms, "segment_seconds": bare_secs,
                   "index_select_launches_per_step":
                       trisk.take_launches / (nseg * seg),
                   "max_rel_diff_vs_table_path": bare_diff}}
        del g, bare, out, bare_out
        return rec

    gp = gather_run("gather path", g48_np)
    emit({"phase": "gather_path", "config": f"reorder_mesh(spherical_icos_"
          f"mesh({N_SPHERE})) (RCM, 16 gather tables) x {NLAYERS} x "
          f"{NTRACERS} float32, bottom_depth 4000, h = (depth + sin 2 lat "
          "cos lon) / K, tracers 10, u = 0.01 x noise, dt=30 "
          "visc_del2=1e3 visc_del4=1e9; forward_backward_step through "
          "run_steps (bench.py OMEGA_PATCHES=0)",
          "host_reorder_mesh_s": reorder_s,
          "host_warm_gather_s_of_it": warm_s, **gp})

    # ----------------------------------------------- 10i. coastal_gather_path
    # the same at full width on a carved icos48: land where |lat| < 60 deg
    # and 0 <= lon < 40 deg (about 10% of the cells), then reorder_mesh.
    # The coast's 2-slot table entries have weight 0; u stays 0 on the
    # coast edges, and the reordered mesh keeps the carved mesh's coast
    lat = np.asarray(s48_np.lat_cell)
    lon = np.mod(np.asarray(s48_np.lon_cell), 2 * np.pi)
    land = (np.abs(lat) < np.deg2rad(60.0)) & (lon < np.deg2rad(40.0))
    t_m = time.perf_counter()
    c48_carved = carve_mesh(s48_np, ~land)
    c48_np = reorder_mesh(c48_carved)
    coast_build_s = time.perf_counter() - t_m
    n_coast = int((np.asarray(c48_carved.edge_mask) == 0).sum())
    if int((np.asarray(c48_np.edge_mask) == 0).sum()) != n_coast \
            or n_coast == 0 or len(c48_np.gather_info) != 16:
        fail(f"coastal gather path: {n_coast} coast edges carved, "
             f"{int((np.asarray(c48_np.edge_mask) == 0).sum())} after "
             "reorder_mesh")
    cg = gather_run("coastal gather path", c48_np)
    emit({"phase": "coastal_gather_path", "config": "as gather_path on "
          f"carve_mesh(spherical_icos_mesh({N_SPHERE})) without |lat| < 60 "
          "deg, 0 <= lon < 40 deg, then reorder_mesh; u = 0.01 x noise x "
          "edge_mask", "land_cells": int(land.sum()),
          "carved_coast_edges": n_coast,
          "host_carve_and_reorder_s": coast_build_s, **cg})

    # ----------------------------------------------------- 10j. gather_split
    # the composed split stepper on the gather layout and on the carved
    # mesh sends its subcycles to the gather-form kernel on the card
    # (stepping/split.subcycle_route): the kernel against the plain loop at
    # the flat phase's inputs of sphere_state (u = 0.01 x noise x
    # edge_mask), every BT_CASES case, float64 per output within 1e-12 of
    # max|ref|, float32 by the increment, PATCH_INCR, u = 0 on the coast;
    # then one composed split step of each (column ssh, dt = 120 s, M = 10,
    # float32): one bt_gather launch, the rest gather launches, against the
    # composed step with the plain loop, per field max|diff| <=
    # GATHER_SPLIT_F32 max|ref| (the subcycles' float32 increments carried
    # into u_new and the transport velocity)
    GATHER_SPLIT_F32 = 1e-5
    cfg_gs = bench_cfg(NLAYERS, NTRACERS, ssh_formulation="column")
    gsp = {"tolerance": "subcycles f64 per output max|diff| <= 1e-12 "
           "max|ref|, f32 per output the error of the increment <= "
           "PATCH_INCR; a composed split step per field max|diff| <= "
           "GATHER_SPLIT_F32 max|ref|", "GATHER_SPLIT_F32": GATHER_SPLIT_F32}
    for name, mnp in (("gather", g48_np), ("coastal", c48_np)):
        st = sphere_state(mnp, NLAYERS, NTRACERS, torch.float32, 0.01, 0.0)
        cases = {"f64": {}, "f32": {}}
        for nm, dt_ in (("f64", torch.float64), ("f32", torch.float32)):
            m_ = mnp.to(dev, dt_)
            h_, u_ = st.h.to(dt_), st.u.to(dt_)
            he = trisk.cell_mean_on_edge(m_, h_)
            mask = trisk.col(m_, "edge_mask")
            ins_ = (_depth_avg_edge(he, u_),
                    h_.sum(-1, keepdim=True) - trisk.col(m_, "bottom_depth"),
                    1e-6 * torch.sin(torch.arange(
                        mnp.nedges, device=dev, dtype=dt_))[:, None] * mask,
                    he.sum(-1, keepdim=True))
            for M, r in BT_CASES:
                kw = dict(gravity=cfg_gs.gravity, dt_bt=DT_SPLIT / M,
                          n_subcycles=M, bt_drag=r)
                got_bt = bt_gather.bt_subcycles(m_, *ins_, **kw)
                ref_bt = bt_gather.subcycles_plain(m_, *ins_, **kw)
                cases[nm][f"M={M} r={r}"] = max(
                    nerr(a_, b_) if nm == "f64" else
                    incr_err(a_.T, b_.T, s_.T)[0] for a_, b_, s_
                    in zip(got_bt, ref_bt, (ins_[0], ins_[1], ins_[0])))
                coast_ub = got_bt[0][mask[:, 0] == 0]
                if coast_ub.numel() and coast_ub.abs().max().item() != 0.0:
                    fail(f"gather split {name} {nm} M={M}: ub on the coast")
        if not (max(cases["f64"].values()) <= 1e-12
                and max(cases["f32"].values()) <= PATCH_INCR):
            fail(f"gather split {name}: subcycles vs plain {cases}")
        g = mnp.to(dev, torch.float32)
        reset_counts()
        one = split_forward_backward_step(g, cfg_gs, st, 0.0, DT_SPLIT)
        torch.cuda.synchronize()
        got_l = counts()
        if got_l["gather"] <= 0:
            fail(f"gather split {name}: no gather launch")
        check_launches(f"gather split {name}", got_l,
                       {**none, "bt_gather": 1, "gather": got_l["gather"]})
        ref = composed(split_forward_backward_step, g, cfg_gs, st, 0.0,
                       DT_SPLIT)
        torch.cuda.synchronize()
        errs = {f: nerr(a_, b_) for f, a_, b_ in
                zip(("h", "u", "tracers"), one, ref)}
        if not max(errs.values()) <= GATHER_SPLIT_F32 or not all(
                bool(torch.isfinite(a_).all()) for a_ in one):
            fail(f"gather split {name}: step vs composed {errs}")
        gsp[name] = {"subcycles": cases, "step_vs_plain_loop": errs,
                     "launches_per_step": got_l}
        del g, one, ref, st
    emit({"phase": "gather_split", **gsp})

    # ------------------------------------------------------- 11. rk_order
    # the manufactured solution (tests/test_model.py:79-166) in float64 on
    # the card; custom tendencies run the composed steppers, every stencil
    # through the stencil kernel
    from omega_tpu_torch.core import ManufacturedConfig, manufactured

    def manufactured_setup(n):
        m_np = planar_hex_mesh(n, n, dc=5.0e6 / n, f0=1e-4,
                               bottom_depth=1000.0)
        m = m_np.to(dev, torch.float64)
        cfg_m = ModelConfig(
            nvertlayers=1, ntracers=0,
            manufactured=ManufacturedConfig(wavelength_x=m_np.x_period,
                                            wavelength_y=m_np.y_period,
                                            amplitude=2.0),
            tendencies=TendencyConfig(
                velocity_diffusion=True, visc_del2=0.0,
                velocity_hyperdiff=False, visc_del4=0.0,
                tracer_horz_adv=False, tracer_diffusion=False,
                tracer_hyperdiff=False, use_custom_tendency=True,
                manufactured_tendency=True))
        p = manufactured.make_params(cfg_m, 1000.0)
        st = ModelState(
            h=1000.0 + manufactured.exact_ssh(p, m.x_cell, m.y_cell,
                                              0.0)[:, None],
            u=manufactured.exact_normal_velocity(p, m, 0.0)[:, None],
            tracers=torch.zeros((0, m.ncells, 1), dtype=torch.float64,
                                device=dev))
        return m, cfg_m, p, st

    t_order = time.perf_counter()
    reset_counts()
    m16, cfg_m, _, st16 = manufactured_setup(16)
    if any(megastep.supported(m16, cfg_m, k) for k in ("fb", "rk2", "rk4")):
        fail("custom tendencies unexpectedly taken by a fused kernel")
    horizon = 1600.0

    def time_err(stepper, n):
        out = run_steps(m16, cfg_m, st16, 0.0, horizon / n, n,
                        stepper=stepper)
        ref = run_steps(m16, cfg_m, st16, 0.0, horizon / n / 8, n * 8,
                        stepper=rk4_step)
        return torch.sqrt(torch.mean((out.h - ref.h) ** 2)).item()

    orders = {}
    for name, stp, n1, n2 in (("fb", forward_backward_step, 16, 32),
                              ("rk2", rk2_step, 4, 8),
                              ("rk4", rk4_step, 4, 8)):
        orders[name] = float(np.log2(time_err(stp, n1) / time_err(stp, n2)))

    def space_err(n, nsteps, dt):
        m, cfg_n, p, st = manufactured_setup(n)
        out = run_steps(m, cfg_n, st, 0.0, dt, nsteps, stepper=rk4_step)
        exact = manufactured.exact_ssh(p, m.x_cell, m.y_cell, nsteps * dt)
        a = m.area_cell
        return torch.sqrt(torch.sum(a * (out.h[:, 0] - 1000.0 - exact) ** 2)
                          / torch.sum(a * exact ** 2)).item()

    e16, e32 = space_err(16, 8, 2400.0 / 8), space_err(32, 16, 2400.0 / 16)
    order_launches = counts()
    orders["space"] = float(np.log2(e16 / e32))
    if not (orders["fb"] > 0.85 and orders["rk2"] > 1.6
            and orders["rk4"] > 3.2 and orders["space"] > 1.5 and e16 < 0.1):
        fail(f"rk_order: orders {orders}, coarse error {e16}")
    if order_launches["stencil"] <= 0 or order_launches["rk_stage"] != 0 \
            or order_launches["fb_step"] != 0:
        fail(f"rk_order: launches {order_launches}")
    emit({"phase": "rk_order", "config": "manufactured solution, planar "
          "16x16 (time) and 16x16 / 32x32 (space), Lx = 5e6 m, 1 layer, "
          "float64, RK4 reference at dt/8; bounds fb > 0.85, rk2 > 1.6, "
          "rk4 > 3.2, space > 1.5 with coarse error < 0.1",
          "orders": orders, "space_errors": [e16, e32],
          "launches": order_launches,
          "seconds": time.perf_counter() - t_order})

    # ----------------------------------------------------- 11. driver_path
    # main_path's configuration through the standalone driver's entry
    # points (ocn_init / ocn_run / ocn_finalize), built from a dict Config
    # (no YAML): 30 minutes of 30 s steps (60), a History stream every 10
    # minutes (single precision) and a Restart stream every 15 minutes
    # (double precision, through a pointer file), in a temporary directory
    # removed at the end. The driver reaches the fused FB kernel through
    # run_steps, one segment per alarm: one fb_step launch a step and no
    # other kernel
    import shutil
    import tempfile
    import types

    from omega_tpu_torch import driver as drv
    from omega_tpu_torch.infra.config import Config
    from omega_tpu_torch.infra.time_manager import Alarm, TimeInterval

    T_START = "0001-01-01_00:00:00"
    STEP_SECONDS = 30

    def driver_config(generate, stop, streams, start=T_START, **extra):
        return Config("Omega", {**extra,
            "Timing": {"Level": 2, "AutoFence": True},
            "TimeIntegration": {
                "CalendarType": "No Leap", "TimeStepper": "Forward-Backward",
                "TimeStep": f"0000_00:00:{STEP_SECONDS:02d}",
                "StartTime": start, "StopTime": stop, "RunDuration": "none"},
            "Mesh": {"Generate": generate},
            "VertCoord": {"NVertLayers": NLAYERS},
            "Tracers": {"Base": ["Temperature", "Salinity"]},
            "Tendencies": {"ViscDel2": 1.0e3, "ViscDel4": 1.0e9,
                           "EddyDiff2": 10.0, "EddyDiff4": 0.0},
            "IOStreams": streams})

    PLANE = {"Kind": "planar", "Nx": NX, "Ny": NY, "Dc": 5000.0,
             "F0": 1.0e-4, "BottomDepth": 1000.0}
    HISTORY = {"Filename": "ocn.hist.$SimTime", "Mode": "write",
               "Precision": "single", "Freq": 10, "FreqUnits": "minutes",
               "Contents": ["State", "SshCell", "Tracers"]}
    RESTART_W = {"UsePointerFile": True, "PointerFilename": "ocn.pointer",
                 "Filename": "ocn.restart.$Y-$M-$D_$h.$m.$s",
                 "Mode": "write", "Precision": "double", "Freq": 15,
                 "FreqUnits": "minutes", "Contents": ["Restart"]}
    RESTART_R = {"UsePointerFile": True, "PointerFilename": "ocn.pointer",
                 "Mode": "read", "FreqUnits": "OnStartup",
                 "UseStartEnd": True, "StartTime": "0001-01-01_00:00:01",
                 "EndTime": "9999-12-31_00:00:00", "Contents": ["Restart"]}
    STREAMS = {"History": HISTORY, "RestartWrite": RESTART_W,
               "RestartRead": RESTART_R}

    def sphere_content_of(mesh_, st):
        a = mesh_.area_cell.double()[:, None]
        h64 = st.h.double()
        return ((a * h64).sum().item(),
                [(a * h64 * st.tracers[l].double()).sum().item()
                 for l in range(NTRACERS)])

    def same(a, b):
        return all(bool(torch.equal(x, y)) for x, y in zip(a, b))

    def max_diff(a, b):
        return max((x.double() - y.double()).abs().max().item()
                   for x, y in zip(a, b))

    def drive_model(model, st):
        """ocn_run + ocn_finalize from state `st`: (final state, seconds,
        launches); the counts are zeroed just before ocn_run"""
        model.state = st
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = drv.ocn_finalize(drv.ocn_run(model))
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, counts()

    FB_ONLY = {"fb_step": 0, "rk_stage": 0, "pp81_coeffs": 0,
               "vmix_solve": 0, "stencil": 0, **NO_SPLIT}
    t_drv = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="omega_driver_")
    try:
        nsteps = 60
        stop30 = "0001-01-01_00:30:00"
        # (a) no streams: one segment of 60 steps
        m_a = drv.ocn_init(driver_config(PLANE, stop30, {}),
                           directory=tmp)
        if m_a.model_cfg != cfg or m_a.dtype != torch.float32 \
                or m_a.mesh.structured_nx != NX:
            fail(f"driver: config {m_a.model_cfg} is not main_path's")
        if not megastep.supported(m_a.mesh, m_a.model_cfg):
            fail("driver: the fused FB path declines the driver's mesh")
        st_a, sec_a, la = drive_model(m_a, state0)
        check_launches("driver_path (no streams)", la,
                       {**FB_ONLY, "fb_step": nsteps})
        # (b) the same with an alarm every 10 steps and nothing written:
        # six segments, each stacking and unstacking the state once
        m_b = drv.ocn_init(driver_config(PLANE, stop30, {}),
                           directory=tmp)
        m_b.clock.attach_alarm(Alarm(
            "Segment", interval=TimeInterval.from_string("0000_00:05:00"),
            start=m_b.clock.start_time))
        st_b, sec_b, lb = drive_model(m_b, state0)
        check_launches("driver_path (6 segments)", lb,
                       {**FB_ONLY, "fb_step": nsteps})
        # (c) History every 10 min, Restart at 15 and 30 min
        run_dir = tmp + "/run"
        shutil.os.makedirs(run_dir)
        m_c = drv.ocn_init(driver_config(PLANE, stop30, STREAMS),
                           directory=run_dir)
        st_c, sec_c, lc = drive_model(m_c, state0)
        check_launches("driver_path (streams)", lc,
                       {**FB_ONLY, "fb_step": nsteps})
        files = sorted(shutil.os.listdir(run_dir))
        n_hist = sum(f.startswith("ocn.hist.") for f in files)
        n_rst = sum(f.startswith("ocn.restart.") for f in files)
        if (n_hist, n_rst) != (3, 2):
            fail(f"driver_path: files {files}")
        io_s = m_c.timers.totals["ocnRun/io"]
        step_s = m_c.timers.totals["ocnRun/doStep"]
        # one more history write of the final state, timed alone
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist_path = m_c.streams.write("History", force=True)
        hist_write_s = time.perf_counter() - t0
        hist_bytes = shutil.os.path.getsize(hist_path)
        rst_bytes = max(shutil.os.path.getsize(run_dir + "/" + f)
                        for f in files if f.startswith("ocn.restart."))
        shutil.rmtree(run_dir)
        # (d) run_steps called directly on the same initial state
        reset_counts()
        direct = run_steps(m_a.mesh, cfg, state0, 0.0, DT, nsteps)
        if counts()["fb_step"] != nsteps:
            fail("driver_path: the direct run_steps call did not fuse")
        drv_vs_direct = max_diff(st_a, direct)
        if not (same(st_a, direct) and same(st_b, direct)
                and same(st_c, direct)):
            fail(f"driver_path: the driver's state differs from run_steps "
                 f"by {drv_vs_direct}, {max_diff(st_b, direct)}, "
                 f"{max_diff(st_c, direct)} (6 segments, streams)")
        # (e) a restart chain: 0-15 min writing the restart, then 15-30
        # min from it, against the unbroken run bit for bit
        chain_dir = tmp + "/chain"
        shutil.os.makedirs(chain_dir)
        m_1 = drv.ocn_init(driver_config(PLANE, "0001-01-01_00:15:00",
                                         STREAMS), directory=chain_dir)
        drive_model(m_1, state0)
        m_2 = drv.ocn_init(driver_config(PLANE, stop30, STREAMS,
                                         start="0001-01-01_00:15:00"),
                           directory=chain_dir)
        if str(m_2.clock.get_current_time()) != "0001-01-01_00:15:00" \
                or str(m_2.sim_start) != T_START:
            fail(f"driver_path: restart clock {m_2.clock.get_current_time()}"
                 f", start {m_2.sim_start}")
        st_2, _, l2 = drive_model(m_2, m_2.state)
        check_launches("driver_path (restarted)", l2,
                       {**FB_ONLY, "fb_step": nsteps // 2})
        chain_diff = max_diff(st_2, st_c)
        if not same(st_2, st_c):
            fail(f"driver_path: the restart chain differs from the "
                 f"unbroken run by {chain_diff}")
        shutil.rmtree(chain_dir)
        finite("driver path", st_c)
        d_vol, d_trc = drifts(state0, st_c)
        if d_vol > 1e-5 or d_trc > 1e-5:
            fail(f"driver path: drift {d_vol} / {d_trc}")
        stack_ms = cuda_ms(lambda: megastep.unstack_state(
            m_a.mesh, megastep.stack_state(m_a.mesh, state0), NLAYERS,
            NTRACERS, ModelState), 20)
        emit({"phase": "driver_path",
              "config": f"as main_path through ocn_init / ocn_run / "
              f"ocn_finalize from a dict Config: planar {NX}x{NY} Dc 5000 "
              f"F0 1e-4 BottomDepth 1000, {NLAYERS} layers, Temperature "
              "and Salinity, ViscDel2 1e3 ViscDel4 1e9, float32, TimeStep "
              "30 s, 30 minutes; History (State, SshCell, Tracers; "
              "single) every 10 min, Restart (double, pointer file) every "
              "15 min",
              "steps": nsteps,
              "ms_per_step_no_streams": sec_a / nsteps * 1e3,
              "ms_per_step_6_segments_no_streams": sec_b / nsteps * 1e3,
              "ms_per_step_with_streams": sec_c / nsteps * 1e3,
              "main_path_ms_per_step": ms_step,
              "stack_unstack_ms": stack_ms,
              "with_streams_do_step_s": step_s, "with_streams_io_s": io_s,
              "history_write_s": hist_write_s,
              "history_file_bytes": hist_bytes,
              "restart_file_bytes": rst_bytes,
              "files": files, "launches": lc,
              "launches_per_step": {k: v / nsteps for k, v in lc.items()},
              "launches_restarted_run": l2,
              "state_vs_run_steps_max_abs_diff": drv_vs_direct,
              "bit_for_bit_vs_run_steps": True,
              "restart_chain_max_abs_diff": chain_diff,
              "restart_chain_bit_for_bit": True,
              "volume_drift": d_vol, "tracer_drift": d_trc,
              "seconds": time.perf_counter() - t_drv})
        del m_a, m_b, m_c, m_1, m_2, st_a, st_b, st_c, st_2, direct

        # --------------------------------------------- 12. driver_sphere
        # PatchLayout: true on the icosahedral sphere (icos16 x 100 x 2,
        # float32, dt = 30 s, 20 steps in two segments cut by a History
        # stream of SshCell at 5 minutes): the driver's mesh carries its
        # patch layout, run_steps takes the framed path, six patch-step
        # launches a step and nothing else; the state bit for bit
        # run_steps' on the driver's own mesh and segments
        t_sph = time.perf_counter()
        SPHERE = {"Kind": "sphere", "Subdivisions": 16,
                  "BottomDepth": 4000.0, "PatchLayout": True}
        sph_dir = tmp + "/sphere"
        shutil.os.makedirs(sph_dir)
        m_s = drv.ocn_init(driver_config(
            SPHERE, "0001-01-01_00:10:00",
            {"History": {**HISTORY, "Freq": 5, "Contents": ["SshCell"]}}),
            directory=sph_dir)
        build_s = time.perf_counter() - t_sph
        if m_s.mesh.patch_info is None or not patch_megastep.supported(
                m_s.mesh, m_s.model_cfg, framed=True):
            fail("driver_sphere: the driver's sphere is not on the framed "
                 "patch path")
        host = types.SimpleNamespace(**{
            n: getattr(m_s.mesh, n).cpu().numpy()
            for n in ("lat_cell", "lon_cell", "bottom_depth", "edge_mask")},
            ncells=m_s.mesh.ncells, nedges=m_s.mesh.nedges)
        s0 = sphere_state(host, NLAYERS, NTRACERS, torch.float32, 0.01, 0.0)
        run_steps(m_s.mesh, m_s.model_cfg, s0, 0.0, DT, 1)  # builds tables
        st_s, sec_s, ls = drive_model(m_s, s0)
        nsph = 20
        check_launches("driver_sphere", ls,
                       {**FB_ONLY, "patch_step": patch_megastep.PASSES * nsph})
        if sorted(shutil.os.listdir(sph_dir)) != [
                "ocn.hist.0001-01-01_00:05:00.nc",
                "ocn.hist.0001-01-01_00:10:00.nc"]:
            fail(f"driver_sphere: files {shutil.os.listdir(sph_dir)}")
        # run_steps on the driver's two segments, and in one call: the
        # framed carry is rebuilt from the flat state at a segment's start,
        # so frame positions the kernels computed redundantly (within
        # rounding of their owners) take their owners' values there
        half = run_steps(m_s.mesh, m_s.model_cfg, s0, 0.0, DT, nsph // 2)
        direct_s = run_steps(m_s.mesh, m_s.model_cfg, half, nsph // 2 * DT,
                             DT, nsph // 2)
        sph_diff = max_diff(st_s, direct_s)
        if not same(st_s, direct_s):
            fail(f"driver_sphere: the driver's state differs from run_steps "
                 f"on the same segments by {sph_diff}")
        one_call = run_steps(m_s.mesh, m_s.model_cfg, s0, 0.0, DT, nsph)
        one_call_diff = max_diff(st_s, one_call)
        del half, one_call
        finite("driver sphere", st_s)
        (v0, t0_), (v1, t1_) = (sphere_content_of(m_s.mesh, s)
                                for s in (s0, st_s))
        s_vol = abs(v1 - v0) / v0
        s_trc = max(abs(b - a) / abs(a) for a, b in zip(t0_, t1_))
        if s_vol > 1e-5 or s_trc > 1e-5:
            fail(f"driver_sphere: drift {s_vol} / {s_trc}")
        emit({"phase": "driver_sphere",
              "config": f"Mesh.Generate sphere Subdivisions 16 PatchLayout "
              f"true ({m_s.mesh.ncells} cells) BottomDepth 4000, {NLAYERS} "
              "layers x 2 tracers, float32, as sphere_path otherwise; "
              "History of SshCell every 5 min",
              "init_seconds": build_s, "steps": nsph,
              "ms_per_step_with_streams": sec_s / nsph * 1e3,
              "launches": ls,
              "launches_per_step": {k: v / nsph for k, v in ls.items()},
              "state_vs_run_steps_max_abs_diff": sph_diff,
              "bit_for_bit_vs_run_steps_same_segments": True,
              "vs_run_steps_one_segment_max_abs_diff": one_call_diff,
              "volume_drift": s_vol, "tracer_drift": s_trc,
              "seconds": time.perf_counter() - t_sph})
        driver_launches = {"fb_step": lc["fb_step"],
                           "patch_step": ls["patch_step"]}
        del m_s, st_s, direct_s
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ------------------------------------------------ 13. kernel_patch_land
    # every patch kernel on a land-masked sphere (mesh/icos_patches.
    # apply_land_mask: edge_mask 0 on edges touching land, the land cells'
    # kite weights 0) against its plain version at the per-kind limits
    # above: icos16 x 8 x 2 float64 with land above 55 deg (tests/
    # test_boundary.py's) — the FB step, the science variant with PP81
    # (coefficient and solve kernels), FCT's stages A and B, the RK stage
    # (mode mid), splitpre / splitpost; icos48 x 100 x 2 float32, land
    # above 55 deg, the FB step and the science variant by the increment
    # (PATCH_INCR, SCI_INCR). After every launch that writes u, u is 0 on
    # the masked edges' frame positions
    from omega_tpu_torch.io.netcdf import read_netcdf
    from omega_tpu_torch.mesh.carve import carve_mesh
    from omega_tpu_torch.mesh.icos_patches import apply_land_mask
    from omega_tpu_torch.mesh.reorder import reorder_mesh
    from omega_tpu_torch.parallel import native, patch_shard
    from omega_tpu_torch.parallel import decomp as pdecomp
    from omega_tpu_torch.parallel import sharded as psharded
    from omega_tpu_torch.parallel import structured_shard as sshard

    t_land = time.perf_counter()

    def masked_pos(p, mesh_np_):
        """(3, P) frame positions of real edges whose mask is 0"""
        cont = p.mg.content["edge"].reshape(3, p.P)
        em = np.asarray(mesh_np_.edge_mask)
        return torch.as_tensor((cont >= 0) & (em[np.maximum(cont, 0)] == 0),
                               device=dev)

    def u_on_masked(out, mpos):
        """max |u| of a launch's output at the masked edges (channels 1-3)"""
        return out[:, 1:4][:, mpos].abs().max().item()

    lnd = {"tolerance": "as kernel_patch / _science / _fct / _rk / _split: "
           "f64 per channel max|diff| <= 1e-12 max|ref| (FCT 1e-14, split "
           "SPLIT_F64), f32 by the increment (PATCH_INCR, SCI_INCR); u == 0 "
           "on masked edges after every launch that writes u",
           "land": "lat > 55 deg"}
    land16 = np.asarray(m16_np.lat_cell) > np.deg2rad(55.0)
    l16_np = apply_land_mask(m16_np, land16)
    l16 = l16_np.to(dev, torch.float64)
    pl16 = patch_megastep.prep(l16, torch.float64, dev)
    if isinstance(pl16.consts["edge_mask"], float):
        fail("kernel_patch_land: the land mask is not a per-position plane")
    mp16 = masked_pos(pl16, l16_np)
    lnd["icos16_masked_edges"] = int((np.asarray(l16_np.edge_mask) == 0).sum())
    umax16 = 0.0
    # the FB step
    st = sphere_state(l16_np, 8, NTRACERS, torch.float64, 0.1, 1.0)
    fr, fix = patch_megastep.stack_frames(l16, cfg16, st)
    got = patch_megastep.chain(pl16, cfg16, fr, DT)
    ref = patch_megastep.chain_plain(pl16, cfg16, fr, DT)
    torch.cuda.synchronize()
    errs = {"fb": chan_err(got.transpose(0, 1), ref.transpose(0, 1))}
    umax16 = max(umax16, u_on_masked(got, mp16))
    # the science variant: upwind fluxes, wind, drag, PP81
    cfg_ls = bench_cfg(8, NTRACERS, SCI_WIND_DRAG, vert_mix=PP81, **UPWIND)
    st = sphere_strat(l16_np, 8, torch.float64, 0.1)
    fr, _ = patch_megastep.stack_frames(l16, cfg_ls, st)
    pw = patch_megastep.make_wind(l16, cfg_ls,
                                  sphere_wind(l16_np, torch.float64),
                                  torch.float64)
    got = patch_megastep.chain(pl16, cfg_ls, fr, DT, wind=pw)
    hz = patch_megastep.chain_plain(pl16, cfg_ls, fr, DT, wind=pw)
    coef = patch_megastep.vmix_coeffs_plain(pl16, cfg_ls, hz)
    kc = patch_megastep.vmix_coeffs(pl16, cfg_ls, hz)
    sv = patch_megastep.vmix_solve(pl16, cfg_ls, hz.clone(), DT, coef)
    sp = patch_megastep.vmix_solve_plain(pl16, cfg_ls, hz, DT, coef)
    torch.cuda.synchronize()
    errs["science_step"] = chan_err(got.transpose(0, 1), hz.transpose(0, 1))
    errs["science_coeffs"] = max(nan_err(kc[:-1], coef[:-1]))
    errs["science_solve"] = chan_err(sv.transpose(0, 1), sp.transpose(0, 1))
    umax16 = max(umax16, u_on_masked(got, mp16), u_on_masked(sv, mp16))
    # FCT's two stages
    cfg_lf = bench_cfg(8, NTRACERS, dict(eddy_diff4=1e9),
                       flux_tracer_type="fct")
    pl16f = patch_megastep.prep(l16, torch.float64, dev, fct=True)
    st = sphere_fct_state(l16_np, 8, torch.float64, 0.1)
    fr, fix = patch_megastep.stack_frames(l16, cfg_lf, st)
    got_a, ref_a, got_b, ref_b, _ = fct_stages(pl16f, cfg_lf, fr, fix)
    fe = fct_errs(got_a, ref_a, got_b, ref_b)
    errs["fct_a"] = max(fe["stage_a"].values())
    errs["fct_b"] = max(fe["stage_b"].values())
    umax16 = max(umax16, u_on_masked(got_a, mp16))
    # the RK stage, mode mid
    st = sphere_state(l16_np, 8, NTRACERS, torch.float64, 0.1, 1.0)
    fr, _ = patch_megastep.stack_frames(l16, cfg16, st)
    prov, acc, _, _ = rk_inputs(pl16, cfg16, fr, None)
    out_r, acc_r = torch.empty_like(fr), torch.empty_like(fr)
    ref_acc, ref_r = rk_call(pl16, cfg16, "mid", fr, prov, acc, None, out_r,
                             acc_r, None)
    torch.cuda.synchronize()
    errs["rk_mid"] = max(chan_err(out_r.transpose(0, 1),
                                  ref_r.transpose(0, 1)),
                         chan_err(acc_r.transpose(0, 1),
                                  ref_acc.transpose(0, 1)))
    umax16 = max(umax16, u_on_masked(out_r, mp16))
    # splitpre / splitpost (and the subcycles they feed)
    rec, _ = split_checks(l16, pl16, cfg16p, st)
    errs["split_pre"] = max(rec["split_pre"])
    errs["split_post"] = max(rec["split_post"])
    errs["bt_gather"] = max(max(rec[f"bt_drag_{r}"]["rel"])
                            for r in (0.0, 1e-4))
    lim = {"fct_a": 1e-14, "fct_b": 1e-14, "split_pre": SPLIT_F64,
           "split_post": SPLIT_F64, "bt_gather": SPLIT_F64}
    bad = {k: v for k, v in errs.items() if not v <= lim.get(k, 1e-12)}
    if bad or umax16 != 0.0:
        fail(f"kernel_patch_land at icos16 f64: {bad}, u on masked edges "
             f"{umax16}")
    lnd["f64_icos16x8x2"] = errs
    lnd["f64_u_on_masked_edges"] = umax16
    del fr, fix, got, ref, hz, sv, sp, got_a, ref_a, got_b, ref_b, out_r

    # float32 at icos48 x 100 x 2
    land48 = np.asarray(m48_np.lat_cell) > np.deg2rad(55.0)
    l48_np = apply_land_mask(m48_np, land48)
    l48 = l48_np.to(dev, torch.float32)
    pl48 = patch_megastep.prep(l48, torch.float32, dev)
    mp48 = masked_pos(pl48, l48_np)
    st = sphere_state(l48_np, NLAYERS, NTRACERS, torch.float32, 0.01, 1.0)
    fr, _ = patch_megastep.stack_frames(l48, cfg48, st)
    got = patch_megastep.chain(pl48, cfg48, fr, DT)
    ref = patch_megastep.chain_plain(pl48, cfg48, fr, DT)
    torch.cuda.synchronize()
    inc_fb = incr_err(got.transpose(0, 1), ref.transpose(0, 1),
                      fr.transpose(0, 1))
    umax48 = u_on_masked(got, mp48)
    del ref
    cfg_ls48 = bench_cfg(NLAYERS, NTRACERS, SCI_WIND_DRAG, vert_mix=PP81,
                         **UPWIND)
    st = sphere_strat(l48_np, NLAYERS, torch.float32, 0.01)
    fr, _ = patch_megastep.stack_frames(l48, cfg_ls48, st)
    pw = patch_megastep.make_wind(l48, cfg_ls48,
                                  sphere_wind(l48_np, torch.float32),
                                  torch.float32)
    got = patch_megastep.chain(pl48, cfg_ls48, fr, DT, wind=pw)
    ref = patch_megastep.chain_plain(pl48, cfg_ls48, fr, DT, wind=pw)
    torch.cuda.synchronize()
    inc_sci = incr_err(got.transpose(0, 1), ref.transpose(0, 1),
                       fr.transpose(0, 1))
    umax48 = max(umax48, u_on_masked(got, mp48))
    if max(inc_fb) > PATCH_INCR or max(inc_sci) > SCI_INCR \
            or umax48 != 0.0 or not bool(torch.isfinite(got).all()):
        fail(f"kernel_patch_land at icos48 f32: FB {inc_fb}, science "
             f"{inc_sci}, u on masked edges {umax48}")
    lnd[f"f32_icos{N_SPHERE}x{NLAYERS}x{NTRACERS}"] = {
        "fb_increments": dict(zip(names, inc_fb)),
        "science_increments": dict(zip(names, inc_sci)),
        "u_on_masked_edges": umax48,
        "masked_edges": int((np.asarray(l48_np.edge_mask) == 0).sum())}
    lnd["seconds"] = time.perf_counter() - t_land
    emit({"phase": "kernel_patch_land", **lnd})
    del fr, got, ref, pl48, l48, l48_np

    # ----------------------------------------------- 14. coastal_patch_path
    # sphere_path on the patch layout masked by coastal_gather_path's
    # continent (|lat| < 60 deg, 0 <= lon < 40 deg): 20 FB steps through
    # run_steps, six patch-step launches a step and nothing else, u = 0 on
    # the masked edges, the land cells' h unchanged (their tracers within
    # four ulps: (tr h + 0) / h rounds), volume and
    # tracer content conserved; in float64 at icos16 the same continent
    # masked on the patch layout against carve_mesh's gather layout
    # (reorder_mesh) at every ocean cell, tests/test_boundary.py:229's 1e-9
    def continent(mesh_np_):
        lat = np.asarray(mesh_np_.lat_cell)
        lon = np.mod(np.asarray(mesh_np_.lon_cell), 2 * np.pi)
        return (np.abs(lat) < np.deg2rad(60.0)) & (lon < np.deg2rad(40.0))

    t_cp = time.perf_counter()
    land48 = continent(m48_np)
    c48p_np = apply_land_mask(m48_np, land48)
    c48p = c48p_np.to(dev, torch.float32)
    cst0 = sphere_state(c48p_np, NLAYERS, NTRACERS, torch.float32, 0.01, 0.0)
    run_steps(c48p, cfg48, cst0, 0.0, DT, 1)           # builds the tables
    cp_build_s = time.perf_counter() - t_cp
    reset_counts()
    cst, cp_s = cst0, []
    for i in range(nseg):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cst = run_steps(c48p, cfg48, cst, i * seg * DT, DT, seg)
        torch.cuda.synchronize()
        cp_s.append(time.perf_counter() - t0)
    cp_launches = counts()
    check_launches("coastal patch path", cp_launches,
                   {"fb_step": 0, "rk_stage": 0, "pp81_coeffs": 0,
                    "vmix_solve": 0, "stencil": 0, **NO_SPLIT, **NO_PATCH,
                    "patch_step": patch_megastep.PASSES * nseg * seg})
    finite("coastal patch path", cst)
    masked48 = torch.as_tensor(np.asarray(c48p_np.edge_mask) == 0,
                               device=dev)
    cp_umask = cst.u[masked48].abs().max().item()
    lm = torch.as_tensor(land48, device=dev)
    # land cells: h exactly, the tracers within rounding of (tr h + 0) /
    # h, four ulps of their value
    land_tr = ((cst.tracers[:, lm] - cst0.tracers[:, lm]).abs().max()
               / cst0.tracers[:, lm].abs().max()).item()
    land_same = bool(torch.equal(cst.h[lm], cst0.h[lm])) \
        and land_tr <= 4 * torch.finfo(torch.float32).eps
    (v0, t0_), (v1, t1_) = sphere_content(cst0), sphere_content(cst)
    cp_vol = abs(v1 - v0) / v0
    cp_trc = max(abs(b - a) / abs(a) for a, b in zip(t0_, t1_))
    if cp_umask != 0.0 or not land_same or cp_vol > 1e-5 or cp_trc > 1e-5:
        fail(f"coastal patch path: u on masked edges {cp_umask}, land "
             f"unchanged {land_same}, drift {cp_vol} / {cp_trc}")
    pc48 = patch_megastep.prep(c48p, torch.float32, dev)
    frc, fixc = patch_megastep.stack_frames(c48p, cfg48, cst0)
    outc = torch.empty_like(frc)
    workc = patch_megastep.new_work(frc)
    cp_chain_ms = cuda_ms(lambda: patch_megastep.chain(
        pc48, cfg48, frc, DT, outc, workc), 20)
    subc = patch_megastep._sub_state(pc48, frc, fixc)
    cp_sub_ms = cuda_ms(lambda: forward_backward_step(
        pc48.sub_mesh, cfg48, subc, 0.0, DT), 10)
    nfixc = patch_megastep._fix_rows(pc48, *subc)
    cp_refresh_ms = cuda_ms(lambda: patch_megastep._refresh_frames(
        pc48, outc, nfixc, pc48.persist), 10)
    del frc, outc, workc, subc, pc48
    # float64 at icos16: masked patch layout against the carved gather one
    land16 = continent(m16_np)
    c16p = apply_land_mask(m16_np, land16).to(dev, torch.float64)
    s16_np = spherical_icos_mesh(m16_np.patch_info.n)
    c16g_np = reorder_mesh(carve_mesh(s16_np, ~continent(s16_np)))
    c16g = c16g_np.to(dev, torch.float64)
    cfg16c = bench_cfg(8, 1, dict(eddy_diff4=1e9))

    def smooth(mesh_np_):
        lat = np.asarray(mesh_np_.lat_cell)
        lon = np.asarray(mesh_np_.lon_cell)
        h = (4000.0 + 2.0 * np.sin(2 * lat) * np.cos(lon))[:, None] / 8 \
            * np.ones((1, 8))
        return ModelState(h=put(h, torch.float64),
                          u=put(np.zeros((mesh_np_.nedges, 8)), torch.float64),
                          tracers=put((10.0 + np.cos(lat))[None, :, None]
                                      * np.ones((1, 1, 8)), torch.float64))
    out_p = run_steps(c16p, cfg16c, smooth(m16_np), 0.0, DT, 10)
    out_g = run_steps(c16g, cfg16c, smooth(c16g_np), 0.0, DT, 10)
    kp = {(round(float(a), 9), round(float(b), 9)): i for i, (a, b) in
          enumerate(zip(np.asarray(m16_np.lat_cell),
                        np.asarray(m16_np.lon_cell)))}
    rows_g = np.arange(c16g_np.ncells)
    rows_p = np.array([kp[(round(float(a), 9), round(float(b), 9))]
                       for a, b in zip(np.asarray(c16g_np.lat_cell),
                                       np.asarray(c16g_np.lon_cell))])
    cp_vs_carved = max(
        (out_p.h[torch.as_tensor(rows_p, device=dev)]
         - out_g.h[torch.as_tensor(rows_g, device=dev)]).abs().max().item(),
        (out_p.tracers[:, torch.as_tensor(rows_p, device=dev)]
         - out_g.tracers).abs().max().item())
    if not cp_vs_carved <= 1e-9:
        fail(f"coastal patch path: icos16 f64 masked vs carved "
             f"{cp_vs_carved}")
    cp_ms = cp_s[-1] / seg * 1e3
    emit({"phase": "coastal_patch_path", "config": f"as sphere_path on "
          f"apply_land_mask(patch_icos_mesh(icos{N_SPHERE})) with land "
          "|lat| < 60 deg, 0 <= lon < 40 deg (coastal_gather_path's "
          "continent); u = 0.01 x noise x edge_mask",
          "land_cells": int(land48.sum()),
          "masked_edges": int(masked48.sum().item()),
          "host_build_s": cp_build_s, "steps": nseg * seg,
          "segment_seconds": cp_s, "ms_per_step": cp_ms,
          "sphere_path_ms_per_step": sph_ms,
          "launches": cp_launches,
          "launches_per_step": {k: v / (nseg * seg)
                                for k, v in cp_launches.items()},
          "u_on_masked_edges": cp_umask, "land_h_unchanged": land_same,
          "land_tracers_max_rel_change": land_tr,
          "volume_drift": cp_vol, "tracer_drift": cp_trc,
          "breakdown_ms": {"patch_step": cp_chain_ms,
                           "submesh_step": cp_sub_ms,
                           "refresh": cp_refresh_ms},
          "f64_icos16_vs_carved_gather_10_steps": cp_vs_carved,
          "seconds": time.perf_counter() - t_cp})
    del c48p, cst, cst0, c16p, c16g, out_p, out_g

    # ----------------------------------------------------- 15. sharded_path
    # main_path's configuration (256 x 256 x 100 x 2 float32, flagship FB)
    # on the structured decomposition, S = 2 and 4 row bands of 256 x (256 /
    # S + 8) local rows, every shard on this card: a step is one fused FB
    # launch a shard (the 72-row local mesh of S = 4 has a ragged last row
    # of the kernel's 16-row tiles) and the two-stage block exchange; no
    # composed step. The owned values after 20 steps against run_steps'
    # unsharded ones (bound 1e-6 of max|ref| a field; bit for bit
    # reported); ms a step beside the unsharded step timed in this phase,
    # and the exchange's share (CUDA events around the list-level exchange
    # of the state)
    t_sh = time.perf_counter()
    nsh = nseg * seg
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref_sh = run_steps(mesh, cfg, state0, 0.0, DT, nsh)
    torch.cuda.synchronize()
    unsharded_ms = (time.perf_counter() - t0) / nsh * 1e3
    shr = {"config": "main_path's, Decomp structured row bands, every shard "
           "on the card", "steps": nsh,
           "unsharded_ms_per_step": unsharded_ms,
           "main_path_ms_per_step": ms_step}
    sharded_launches = {}
    for S in (2, 4):
        ss = sshard.decompose_structured(mesh_np, S)
        devs = psharded.default_devices(S)
        step = sshard.make_sharded_step(ss, cfg, forward_backward_step,
                                        devs, dtype=torch.float32)
        if not all(megastep.supported(m_, cfg) for m_ in step.meshes):
            fail(f"sharded path S={S}: the fused path declines the local "
                 "mesh")
        sts = sshard.shard_state(ss, state0, devs)
        sts = step(sts, 0.0, DT)                        # untimed
        sts = sshard.shard_state(ss, state0, devs)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t_ = 0.0
        for _ in range(nsh):
            sts = step(sts, t_, DT)
            t_ += DT
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        lc_ = counts()
        check_launches(f"sharded path S={S}", lc_,
                       {**FB_ONLY, **NO_PATCH, "fb_step": S * nsh})
        out = sshard.gather_state(ss, sts)
        finite(f"sharded path S={S}", out)
        diffs = {f: (a - b).abs().max().item() / max(b.abs().max().item(), 1e-300)
                 for f, a, b in zip(("h", "u", "tracers"), out, ref_sh)}
        if max(diffs.values()) > 1e-6:
            fail(f"sharded path S={S}: owned values vs unsharded {diffs}")
        halo = sshard.make_halo_fn(ss)
        ex_ms = cuda_ms(lambda: halo(sts), 20)
        st_ms = sec / nsh * 1e3
        # device time of a step, every kernel and copy (torch.profiler)
        dev_ms = kernel_ms(lambda: step(sts, 0.0, DT), {"all": ""},
                           reps=5)["all"]
        shr[f"S{S}"] = {
            "layout": [ss.sy, ss.sx], "local_mesh": [ss.nxl, ss.nyl],
            "ms_per_step": st_ms, "launches": lc_,
            "launches_per_step": {k: v / nsh for k, v in lc_.items()},
            "exchange_ms": ex_ms, "exchange_share": ex_ms / st_ms,
            "device_ms_per_step": dev_ms,
            "device_idle_share": None if dev_ms is None
            else 1.0 - dev_ms / st_ms,
            "vs_unsharded_max_rel": diffs,
            "bit_for_bit": all(bool(torch.equal(a, b))
                               for a, b in zip(out, ref_sh))}
        sharded_launches[S] = lc_["fb_step"]
        del sts, out, step
    shr["seconds"] = time.perf_counter() - t_sh
    emit({"phase": "sharded_path", **shr})
    del ref_sh

    # --------------------------------------------------------- 16. sfc_path
    # the general (SFC) decomposition: a planar 64 x 64 x 20 x 2 mesh in
    # float64, Decomp.Method sfc, S = 4 on this card, FB and RK4, 10 steps,
    # against the unsharded run on the same operator route at
    # tests/test_parallel.py:88's 1e-13; the partition and the halo rings
    # by the native (g++) route
    t_sfc = time.perf_counter()
    m64_np = planar_hex_mesh(64, 64, dc=5000.0, f0=1e-4, bottom_depth=1000.0)
    m64 = m64_np.to(dev, torch.float64)
    m64_gather = dataclasses.replace(m64, structured_nx=0, structured_ny=0,
                                     structured_scalars=())
    # tests/test_model.py's inertia-gravity configuration (no momentum
    # diffusion: RK4's mid-step exchange then keeps owned rows exact)
    cfg64 = ModelConfig(nvertlayers=20, ntracers=NTRACERS,
                        tendencies=TendencyConfig(
                            visc_del2=0.0, velocity_diffusion=False,
                            velocity_hyperdiff=False, tracer_diffusion=True,
                            eddy_diff2=10.0, tracer_hyperdiff=False))
    st64 = noisy_state(m64_np, 20, NTRACERS, torch.float64)
    sm64 = pdecomp.decompose(m64_np, 4, method="hilbert")
    routes = dict(native.ROUTE)
    if not native.available() or set(routes.values()) != {"native"}:
        fail(f"sfc path: the partition did not take the native route "
             f"{routes}")
    devs = psharded.default_devices(4)
    sm64 = sm64.to(devs, torch.float64)
    sfc = {"config": "planar 64 x 64 x 20 x 2 float64, Decomp.Method sfc, "
           "S = 4 on the card", "native_routes": routes,
           "halo_width": sm64.halo_width}
    for name, stp in (("fb", forward_backward_step), ("rk4", rk4_step)):
        step = psharded.make_sharded_step(sm64, cfg64, stp, devs)
        sts = psharded.shard_state(sm64, st64)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(10):
            sts = step(sts, i * DT, DT)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        out = psharded.gather_state(sm64, sts, m64.ncells, m64.nedges)
        # the unsharded run on the local meshes' route: the global mesh
        # without its structured tables (the index_select operators, as
        # on the renumbered local meshes; the structured route's stencil
        # kernel sums in another order, 3e-13 apart)
        ref = st64
        for i in range(10):
            ref = stp(m64_gather, cfg64, ref, i * DT, DT)
        d = max((a - b).abs().max().item() / max(b.abs().max().item(), 1e-300)
                for a, b in zip(out, ref))
        if not d <= 1e-13:
            fail(f"sfc path {name}: sharded vs unsharded {d}")
        sfc[name] = {"max_rel_diff": d, "ms_per_step": sec / 10 * 1e3,
                     "bit_for_bit": all(bool(torch.equal(a, b))
                                        for a, b in zip(out, ref)),
                     "launches": counts()}
    sfc["seconds"] = time.perf_counter() - t_sfc
    emit({"phase": "sfc_path", **sfc})
    del sm64, m64, st64

    # ------------------------------------------------ 17. patch_sharded_path
    # the sphere's patch layout sharded: whole patches a shard (S = 5 at
    # icos48 x 100 x 2 float32, flagship FB, 20 steps), each shard's patch
    # kernel on its own frames (six launches a shard a step), copies
    # between shards for the refresh, the pole-fix substep once a card;
    # against the single-device framed run; then icos16 x 8 x 2 float64 at
    # S = 2, 5, 10 and the science tails (wind, drag, PP81), at
    # tests/test_patch_shard.py's 1e-13 / 1e-12
    t_ps = time.perf_counter()
    psh = {"config": f"icos{N_SPHERE} x {NLAYERS} x {NTRACERS} float32 S = "
           "5; icos16 x 8 x 2 float64 S = 2, 5, 10 and the science tails"}
    devs = psharded.default_devices(5)
    run5 = patch_shard.make_patch_sharded_run(m48, cfg48, 5, devs)
    run5(sph0, 0.0, DT, 1)                                  # untimed
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run5(sph0, 0.0, DT, nsh)
    torch.cuda.synchronize()
    ps_sec = time.perf_counter() - t0
    ps_launches = counts()
    check_launches("patch sharded path", ps_launches,
                   {**FB_ONLY, **NO_PATCH,
                    "patch_step": 5 * patch_megastep.PASSES * nsh})
    ref = run_steps(m48, cfg48, sph0, 0.0, DT, nsh)
    d48 = max((a - b).abs().max().item() / max(b.abs().max().item(), 1e-300)
              for a, b in zip(out, ref))
    if not d48 <= 1e-13:
        fail(f"patch sharded path S=5: vs single device {d48}")
    ps_dev = kernel_ms(lambda: run5(sph0, 0.0, DT, 1), {"all": ""},
                       reps=3)["all"]
    psh["f32_S5"] = {"ms_per_step": ps_sec / nsh * 1e3,
                     "device_ms_per_step_one_step_runs": ps_dev,
                     "sphere_path_ms_per_step": sph_ms,
                     "launches": ps_launches,
                     "launches_per_step": {k: v / nsh for k, v in
                                           ps_launches.items()},
                     "vs_single_device_max_rel": d48,
                     "bit_for_bit": all(bool(torch.equal(a, b))
                                        for a, b in zip(out, ref))}
    del out, ref
    # the icos16 patch mesh anew (rk_order rebinds m16 to a planar mesh)
    m16p = m16_np.to(dev, torch.float64)
    st16 = sphere_state(m16_np, 8, NTRACERS, torch.float64, 0.1, 1.0)
    cfg16s = bench_cfg(8, NTRACERS, SCI_WIND_DRAG, vert_mix=PP81)
    w16s = sphere_wind(m16_np, torch.float64)
    for cname, cfg_v, wind, tol in (("flagship", cfg16, None, 1e-13),
                                    ("science", cfg16s, w16s, 1e-12)):
        ref = run_steps(m16p, cfg_v, st16, 0.0, DT, 3, wind_stress=wind)
        for S in (2, 5, 10):
            reset_counts()
            out = patch_shard.make_patch_sharded_run(
                m16p, cfg_v, S, psharded.default_devices(S))(
                    st16, 0.0, DT, 3, wind_stress=wind)
            lc_ = counts()
            if lc_["patch_step"] != S * patch_megastep.PASSES * 3:
                fail(f"patch sharded {cname} S={S}: launches {lc_}")
            d = max((a - b).abs().max().item() for a, b in zip(out, ref))
            if not d <= tol:
                fail(f"patch sharded {cname} S={S} f64: {d}")
            psh[f"f64_icos16_{cname}_S{S}"] = {
                "max_abs_diff": d, "launches": lc_}
    psh["seconds"] = time.perf_counter() - t_ps
    emit({"phase": "patch_sharded_path", **psh})

    # ---------------------------------------------------- 18. driver_sharded
    # driver_path's configuration with Decomp {NShards: 4, Method:
    # structured, ShardedIO: true}, History every 10 minutes (20 steps),
    # Restart at 10 minutes, 20 minutes: the state equals the unsharded
    # driver's, the History files' variables equal its, and a restart from
    # the sharded restart file (read shard by shard) continues bit for bit;
    # then Method sfc and patch on an icos16 sphere through the driver
    t_ds = time.perf_counter()
    tmp2 = tempfile.mkdtemp(prefix="omega_driver_sharded_")
    try:
        HIST20 = {**HISTORY, "Precision": "double"}
        RST10 = {**RESTART_W, "Freq": 10}
        st_streams = {"History": HIST20, "RestartWrite": RST10,
                      "RestartRead": RESTART_R}
        stop20 = "0001-01-01_00:20:00"
        DEC = {"NShards": 4, "Method": "structured", "ShardedIO": True}

        d_one, d_four = tmp2 + "/one", tmp2 + "/four"
        shutil.os.makedirs(d_one)
        shutil.os.makedirs(d_four)
        m_1 = drv.ocn_init(driver_config(PLANE, stop20, st_streams),
                           directory=d_one)
        st_1, sec_1, l_1 = drive_model(m_1, state0)
        m_4 = drv.ocn_init(driver_config(PLANE, stop20, st_streams,
                                         Decomp=DEC), directory=d_four)
        if m_4.nshards != 4 or not m_4.sharded_io:
            fail("driver_sharded: the Decomp group did not take")
        st_4, sec_4, l_4 = drive_model(m_4, state0)
        check_launches("driver_sharded", l_4,
                       {**FB_ONLY, **NO_PATCH, "fb_step": 4 * 40})
        ds_diff = max_diff(st_4, st_1)
        if not same(st_4, st_1):
            fail(f"driver_sharded: the sharded driver's state differs from "
                 f"the unsharded one's by {ds_diff}")
        files = sorted(f for f in shutil.os.listdir(d_one)
                       if f.startswith("ocn.hist."))
        if files != sorted(f for f in shutil.os.listdir(d_four)
                           if f.startswith("ocn.hist.")) or len(files) != 2:
            fail(f"driver_sharded: history files {files}")
        for f in files:
            a_, b_ = (read_netcdf(d + "/" + f) for d in (d_one, d_four))
            for k in a_.variables:
                if not np.array_equal(a_.variables[k], b_.variables[k]):
                    fail(f"driver_sharded: {f} {k} differs")
        # the restart chain: 10 -> 20 min from the sharded restart at 10
        with open(d_four + "/ocn.pointer", "w") as fp:
            fp.write("ocn.restart.0001-01-01_00.10.00.nc\n")
        m_r = drv.ocn_init(driver_config(PLANE, stop20, st_streams,
                                         start="0001-01-01_00:10:00",
                                         Decomp=DEC), directory=d_four)
        if m_r._deferred_state_stream != "RestartRead" \
                or m_r.state is not None:
            fail("driver_sharded: the restart was not read shard by shard")
        out_r = drv.ocn_finalize(drv.ocn_run(m_r))
        rs_diff = max_diff(out_r, st_4)
        if not same(out_r, st_4):
            fail(f"driver_sharded: the restart chain differs by {rs_diff}")
        # Method sfc and Method patch through the driver: icos16 x 100 x 2
        # (the general layout against the unsharded run on the same
        # operators; PatchLayout on 2 patch shards, 2 x 6 patch launches a
        # step, against the unsharded framed run), 10 steps each
        SPH16 = {"Kind": "sphere", "Subdivisions": 16, "BottomDepth": 4000.0}
        stop5 = "0001-01-01_00:05:00"
        methods = {}
        for mname, gen, dec in (
                ("sfc", SPH16, {"NShards": 4, "Method": "sfc"}),
                ("patch", {**SPH16, "PatchLayout": True},
                 {"NShards": 2, "Method": "patch"})):
            d_m = tmp2 + "/" + mname
            shutil.os.makedirs(d_m)
            m_u = drv.ocn_init(driver_config(gen, stop5, {}), directory=d_m)
            host = types.SimpleNamespace(**{
                n: getattr(m_u.mesh, n).cpu().numpy()
                for n in ("lat_cell", "lon_cell", "bottom_depth",
                          "edge_mask")},
                ncells=m_u.mesh.ncells, nedges=m_u.mesh.nedges)
            s0 = sphere_state(host, NLAYERS, NTRACERS, torch.float32, 0.01,
                              0.0)
            st_u, _, l_u = drive_model(m_u, s0)
            m_s = drv.ocn_init(driver_config(gen, stop5, {}, Decomp=dec),
                               directory=d_m)
            st_s, sec_m, l_s = drive_model(m_s, s0)
            if m_s._decomp[0] != mname:
                fail(f"driver_sharded {mname}: ran {m_s._decomp[0]}")
            rel = max((a_ - b_).abs().max().item()
                      / max(b_.abs().max().item(), 1e-300)
                      for a_, b_ in zip(st_s, st_u))
            if mname == "patch" and (l_s["patch_step"] != 2 * 6 * 10
                                     or not same(st_s, st_u)):
                fail(f"driver_sharded patch: launches {l_s}, {rel} from "
                     "the unsharded run")
            if not rel <= 1e-5:
                fail(f"driver_sharded {mname}: {rel} from the unsharded run")
            methods[mname] = {"max_rel_diff": rel,
                              "bit_for_bit": same(st_s, st_u),
                              "ms_per_step": sec_m / 10 * 1e3,
                              "launches": l_s}
        emit({"phase": "driver_sharded",
              "methods_icos16": methods,
              "config": "driver_path's with Decomp NShards 4, structured, "
              "ShardedIO (NetCDF3 region writes, region reads of the "
              "restart); History (double) every 10 min, Restart every 10 "
              "min, 20 minutes",
              "steps": 40, "ms_per_step_with_streams": sec_4 / 40 * 1e3,
              "unsharded_ms_per_step_with_streams": sec_1 / 40 * 1e3,
              "launches": l_4, "state_vs_unsharded_max_abs_diff": ds_diff,
              "history_files_equal": True, "restart_chain_bit_for_bit": True,
              "io_s": m_4.timers.totals.get("ocnRun/io"),
              "seconds": time.perf_counter() - t_ds})
        del m_1, m_4, m_r, st_1, st_4, out_r
    finally:
        shutil.rmtree(tmp2, ignore_errors=True)

    # ----------------------------------------------------- 19. coupling_path
    # the coupled component (omega_tpu_torch.coupling.OmegaComponent) on
    # science_path's configuration (upwind fluxes, wind, drag, PP81) with
    # wind imports: three 10-step intervals against one 30-step run with
    # the same constant wind (the fused science steps in both), and the
    # exports of the same intervals at S = 4 (structured, the state kept
    # sharded across intervals, exports from owned rows) against S = 1
    from omega_tpu_torch.coupling import OmegaComponent
    t_cpl = time.perf_counter()
    tmp3 = tempfile.mkdtemp(prefix="omega_coupling_")
    try:
        sci_doc = {
            "Timing": {"Level": 2, "AutoFence": True},
            "TimeIntegration": {
                "CalendarType": "No Leap",
                "TimeStepper": "Forward-Backward",
                "TimeStep": f"0000_00:00:{STEP_SECONDS:02d}",
                "StartTime": T_START, "StopTime": "0001-01-01_00:15:00",
                "RunDuration": "none"},
            "Mesh": {"Generate": PLANE},
            "VertCoord": {"NVertLayers": NLAYERS},
            "Tracers": {"Base": ["Temperature", "Salinity"]},
            "Tendencies": {"ViscDel2": 1.0e3, "ViscDel4": 1.0e9,
                           "EddyDiff2": 10.0, "EddyDiff4": 0.0,
                           "WindForcingTendencyEnable": True,
                           "BottomDragTendencyEnable": True,
                           "BottomDragCoeff": 3.0e-3},
            "Advection": {"FluxThicknessType": "Upwind",
                          "FluxTracerType": "Upwind"},
            "VertMix": {"Enabled": True, "Scheme": "PP81"},
            "IOStreams": {}}
        imports = {"zonal_wind_stress": 0.05, "merid_wind_stress": 0.01}
        sci_st = sci0

        def component(decomp=None):
            doc = dict(sci_doc, **({"Decomp": decomp} if decomp else {}))
            c = OmegaComponent(config=Config("Omega", doc), directory=tmp3)
            c.model.state = sci_st
            return c
        c1 = component()
        if not megastep.supported(c1.model.mesh, c1.model.model_cfg):
            fail("coupling path: the science configuration is not fused")
        reset_counts()
        ex1 = [c1.run(10 * STEP_SECONDS, imports) for _ in range(3)]
        l_c1 = counts()
        st_c1 = c1.finalize()
        ref_doc = dict(sci_doc, WindStress={"ConstantZonal": 0.05,
                                            "ConstantMeridional": 0.01})
        m_ref = drv.ocn_init(Config("Omega", ref_doc), directory=tmp3)
        st_ref, _, _ = drive_model(m_ref, sci_st)
        cpl_diff = max_diff(st_c1, st_ref)
        if not same(st_c1, st_ref):
            fail(f"coupling path: 3 intervals differ from one 30-step run "
                 f"by {cpl_diff}")
        c4 = component({"NShards": 4, "Method": "structured"})
        reset_counts()
        ex4 = [c4.run(10 * STEP_SECONDS, imports) for _ in range(3)]
        l_c4 = counts()
        if not c4.model._state_is_sharded or len(c4.model.state) != 4:
            fail("coupling path: the state was not kept sharded")
        c4.finalize()
        ex_diff = max(np.abs(a_[k] - b_[k]).max() / max(np.abs(b_[k]).max(),
                                                      1e-300)
                      for a_, b_ in zip(ex4, ex1) for k in b_)
        if set(ex4[0]) != set(ex1[0]) or not ex_diff <= 1e-6:
            fail(f"coupling path: S = 4 exports vs S = 1 {ex_diff}")
        emit({"phase": "coupling_path",
              "config": "science_path's through OmegaComponent, 3 intervals "
              "of 10 steps with wind imports (0.05, 0.01 N m-2)",
              "launches_S1": l_c1, "launches_S4": l_c4,
              "intervals_vs_one_run_max_abs_diff": cpl_diff,
              "intervals_bit_for_bit": True,
              "exports_S4_vs_S1_max_rel": float(ex_diff),
              "exports_bit_for_bit": bool(ex_diff == 0.0),
              "exports": sorted(ex1[0]),
              "seconds": time.perf_counter() - t_cpl})
    finally:
        shutil.rmtree(tmp3, ignore_errors=True)

    # ------------------------------------------------- optional: profile
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        g48, c48 = (m.to(dev, torch.float32) for m in (g48_np, c48_np))
        g48_0, c48_0 = (sphere_state(m, NLAYERS, NTRACERS, torch.float32,
                                     0.01, 0.0) for m in (g48_np, c48_np))

        def traced(fn):
            fn()                                  # untimed first call
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            # device-side rows only: an operator's row repeats the time of
            # the kernels it launched
            rows = sorted(
                ((e.device_time_total, e.count, e.key)
                 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.device_time_total > 0), reverse=True)
            total = sum(r[0] for r in rows)
            return {"device_us_total": total,
                    "top": [{"name": k[:60], "calls": n, "device_us": t}
                            for t, n, k in rows[:12]]}

        emit({"phase": "profile",
              "fused_5_steps": traced(lambda: run_steps(
                  mesh, cfg, state, 0.0, DT, 5)),
              "composed_2_steps": traced(lambda: run_steps(
                  mesh, cfg_col, state, 0.0, DT, 2)),
              "science_5_steps": traced(lambda: run_steps(
                  mesh, cfg_sci, sci, 0.0, DT, 5, wind_stress=wind_sci)),
              "fct_5_steps": traced(lambda: run_steps(
                  mesh, cfg_mono, state0, 0.0, DT, 5)),
              "rk4_5_steps": traced(lambda: run_steps(
                  mesh, cfg, state0, 0.0, DT, 5, stepper=rk4_step)),
              "rk2_science_5_steps": traced(lambda: run_steps(
                  mesh, cfg_sci, sci, 0.0, DT, 5, stepper=rk2_step,
                  wind_stress=wind_sci)),
              "split_5_steps": traced(lambda: run_steps(
                  mesh, cfg_split, state0, 0.0, DT_SPLIT, 5,
                  stepper=split_stepper)),
              "split_science_2_steps": traced(lambda: run_steps(
                  mesh, cfg_ssp, sci0, 0.0, DT_SPLIT, 2,
                  stepper=split_stepper, wind_stress=wind_sci)),
              "sphere_5_steps": traced(lambda: run_steps(
                  m48, cfg48, sph0, 0.0, DT, 5)),
              "sphere_science_5_steps": traced(lambda: run_steps(
                  m48, cfg_ss, ss0, 0.0, DT, 5, wind_stress=w48)),
              "sphere_fct_5_steps": traced(lambda: run_steps(
                  m48, cfg_sf, sf0, 0.0, DT, 5)),
              "sphere_rk4_5_steps": traced(lambda: run_steps(
                  m48, cfg48, sph0, 0.0, DT, 5, stepper=rk4_step)),
              "sphere_rk2_5_steps": traced(lambda: run_steps(
                  m48, cfg_ss, ss0, 0.0, DT, 5, stepper=rk2_step,
                  wind_stress=w48)),
              "sphere_split_5_steps": traced(lambda: run_steps(
                  m48, cfg48p, sp0, 0.0, DT_SPLIT, 5,
                  stepper=split_forward_backward_step)),
              "gather_5_steps": traced(lambda: run_steps(
                  g48, cfg48, g48_0, 0.0, DT, 5)),
              "coastal_gather_5_steps": traced(lambda: run_steps(
                  c48, cfg48, c48_0, 0.0, DT, 5))})

    # ---------------------------------------------------------- 8. kernels
    print(smi_line, flush=True)
    emit({"kernels": [
        {"name": "fb_step", "route": "cuda",
         "source": "omega_tpu_torch/csrc/fb_step.cu",
         "template": "omega_tpu_torch/csrc/fb_step.cuh",
         "replaces": "omega_tpu/ops/megastep.py:880",
         "launches": main_launches["fb_step"],
         "max_abs_err": fbv["flagship"]["max_abs_err"],
         "ms": fbv["flagship"]["ms"],
         "plain_ms": fbv["flagship"]["plain_ms"],
         "bound_ms": fbv["flagship"]["bound_ms"],
         "bound_by": fbv["flagship"]["bound_by"], "library_ms": None,
         "shape": f"({CH}, {NLAYERS}, {NY}, {NX}) float32",
         "variant": "flagship: center fluxes, no tails",
         "path": "main_path",
         "driver_path_launches": driver_launches["fb_step"],
         "sharded_path_launches": {f"S{k}": v
                                   for k, v in sharded_launches.items()},
         "sharded_path_launches_per_step": {
             f"S{k}": v / nsh for k, v in sharded_launches.items()},
         "variants_ms": {v: fbv[v]["ms"] for v in FULL_WIDTH}},
        {"name": "fb_step_upwind_tails", "route": "cuda",
         "source": "omega_tpu_torch/csrc/fb_step_uu.cu",
         "template": "omega_tpu_torch/csrc/fb_step.cuh",
         "replaces": "omega_tpu/ops/megastep.py:880",
         "tails_replaced": "megastep.py:236 _h_fluxes, :249 _htr_flux, "
         ":318 _wind_drag",
         "launches": sci_launches["fb_step"],
         "max_abs_err": fbv["upwind_wind_drag"]["max_abs_err"],
         "ms": fbv["upwind_wind_drag"]["ms"],
         "plain_ms": fbv["upwind_wind_drag"]["plain_ms"],
         "bound_ms": fbv["upwind_wind_drag"]["bound_ms"],
         "bound_by": fbv["upwind_wind_drag"]["bound_by"], "library_ms": None,
         "shape": f"({CH}, {NLAYERS}, {NY}, {NX}) + wind (3, {NY}, {NX}) "
         "float32",
         "variant": "upwind thickness and tracer fluxes, wind and drag",
         "path": "science_path"},
        {"name": "pp81_coeffs", "route": "cuda",
         "source": "omega_tpu_torch/csrc/vmix.cu",
         "replaces": "omega_tpu/ops/megastep.py:389",
         "launches": sci_launches["pp81_coeffs"],
         "max_abs_err": coeff_abs, "ms": coeff_ms,
         "plain_ms": coeff_plain_ms, "bound_ms": coeff_b_ms,
         "bound_by": coeff_b_by, "library_ms": None,
         "shape": f"({CH}, {NLAYERS}, {NY}, {NX}) -> ({KI}, {NY}, {NX}) + "
         f"(3, {KI}, {NY}, {NX}) float32", "path": "science_path",
         "attrs": vmx["coeffs"]["attrs"],
         "groups": vmx["coeffs"]["plan"]["groups"]},
        {"name": "vmix_solve", "route": "cuda",
         "source": "omega_tpu_torch/csrc/vmix.cu",
         "shared": "omega_tpu_torch/csrc/column_solve.cuh",
         "replaces": "omega_tpu/ops/megastep.py:430",
         "also_replaces": "omega_tpu/ops/megastep.py:360",
         "launches": sci_launches["vmix_solve"],
         "max_abs_err": solve_abs, "ms": solve_ms["pp81"],
         "plain_ms": solve_plain_ms, "bound_ms": solve_b["pp81"][0],
         "bound_by": solve_b["pp81"][1], "library_ms": None,
         "shape": f"({CH}, {NLAYERS}, {NY}, {NX}) in place, PP81 "
         "coefficients, float32", "path": "science_path",
         "constant_coefficients": {"ms": solve_ms["constant"],
                                   "bound_ms": solve_b["constant"][0]}},
        {"name": "fb_step_fct", "route": "cuda",
         "source": "omega_tpu_torch/csrc/fb_step_cf.cu",
         "template": "omega_tpu_torch/csrc/fb_step.cuh",
         "replaces": "omega_tpu/ops/megastep.py:263",
         "launches": fct_launches["fb_step"],
         "max_abs_err": fbv["fct"]["max_abs_err"],
         "ms": fbv["fct"]["ms"], "plain_ms": fbv["fct"]["plain_ms"],
         "bound_ms": fbv["fct"]["bound_ms"],
         "bound_by": fbv["fct"]["bound_by"], "library_ms": None,
         "shape": f"({CH}, {NLAYERS}, {NY}, {NX}) float32",
         "variant": "center thickness flux, FCT tracer flux, no tails",
         "path": "fct_path",
         "variants_ms": {"fct_upwind_wind_drag":
                         fbv["fct_upwind_wind_drag"]["ms"]}},
        {"name": "rk_stage", "route": "cuda",
         "source": "omega_tpu_torch/csrc/rk_stage_cc.cu",
         "template": "omega_tpu_torch/csrc/rk_stage.cuh",
         "replaces": "omega_tpu/ops/megastep.py:551",
         "also_replaces": "omega_tpu/ops/megastep.py:622, :687, :698, :712",
         "launches": rk4_launches["rk_stage"],
         "max_abs_err": rkv["flagship"]["max_abs_err"],
         "ms": rkv["flagship"]["modes"]["mid"]["ms"],
         "plain_ms": rkv["flagship"]["modes"]["mid"]["plain_ms"],
         "bound_ms": rkv["flagship"]["modes"]["mid"]["bound_ms"],
         "bound_by": rkv["flagship"]["modes"]["mid"]["bound_by"],
         "library_ms": None,
         "shape": f"mode mid: 3 x ({CH}, {NLAYERS}, {NY}, {NX}) in, 2 out, "
         "float32", "variant": "center fluxes, no tails", "path": "rk4_path",
         "modes_ms": {m: v["ms"] for m, v in
                      rkv["flagship"]["modes"].items()},
         "rk4_step_launches_ms": rkv["flagship"]["rk4_launches_ms"],
         "rk4_step_bound_ms": rkv["flagship"]["rk4_bound_ms"]},
        {"name": "rk_stage_upwind_tails", "route": "cuda",
         "source": "omega_tpu_torch/csrc/rk_stage_uu.cu",
         "template": "omega_tpu_torch/csrc/rk_stage.cuh",
         "replaces": "omega_tpu/ops/megastep.py:622",
         "launches": rk2_launches["rk_stage"],
         "max_abs_err": rkv["upwind_wind_drag"]["max_abs_err"],
         "ms": rkv["upwind_wind_drag"]["modes"]["prov"]["ms"],
         "plain_ms": rkv["upwind_wind_drag"]["modes"]["prov"]["plain_ms"],
         "bound_ms": rkv["upwind_wind_drag"]["modes"]["prov"]["bound_ms"],
         "bound_by": rkv["upwind_wind_drag"]["modes"]["prov"]["bound_by"],
         "library_ms": None,
         "shape": f"mode prov: ({CH}, {NLAYERS}, {NY}, {NX}) + wind (3, "
         f"{NY}, {NX}) in, 1 out, float32",
         "variant": "upwind thickness and tracer fluxes, wind and drag",
         "path": "rk2_path",
         "modes_ms": {m: v["ms"] for m, v in
                      rkv["upwind_wind_drag"]["modes"].items()},
         "rk2_step_launches_ms": rkv["upwind_wind_drag"]["rk2_launches_ms"],
         "rk2_step_bound_ms": rkv["upwind_wind_drag"]["rk2_bound_ms"]},
        {"name": "stencil", "route": "cuda",
         "source": "omega_tpu_torch/csrc/stencil.cu",
         "replaces": "omega_tpu/ops/pallas_stencil_dma.py:55",
         "also_replaces": "omega_tpu/ops/pallas_stencil.py:74",
         "launches": comp_launches["stencil"],
         "max_abs_err": stencil_err_f32,
         "ms": timed["tang"]["ms"], "plain_ms": timed["tang"]["plain_ms"],
         "bound_ms": timed["tang"]["bound_ms"],
         "bound_by": timed["tang"]["bound_by"],
         "library_ms": timed["tang"]["library_ms"],
         "library": "torch.sparse.mm, the stencil as a block-diagonal CSR "
         "matrix (cuSPARSE SpMM)",
         "shape": f"tang on (2, {3 * C}, {NLAYERS}) float32",
         "path": "composed_path", "per_table": timed,
         "split_science_launches": ssp_launches["stencil"],
         "rk_order_launches": order_launches["stencil"]},
        {"name": "split_pre", "route": "cuda",
         "source": "omega_tpu_torch/csrc/split.cu",
         "replaces": "omega_tpu/ops/megastep.py:791",
         "also_replaces": "omega_tpu/ops/megastep.py:744",
         "launches": spl_launches["split_pre"],
         "max_abs_err": splv["split_pre"]["max_abs_err"],
         "ms": splv["split_pre"]["ms"],
         "plain_ms": splv["split_pre"]["plain_ms"],
         "bound_ms": splv["split_pre"]["bound_ms"],
         "bound_by": splv["split_pre"]["bound_by"], "library_ms": None,
         "shape": f"({CH}, {NLAYERS}, {NY}, {NX}) in; (3, {NLAYERS}, {NY}, "
         f"{NX}) + 13 x ({NY}, {NX}) out, float32",
         "passes": splv["split_pre_passes"], "path": "split_path"},
        {"name": "barotropic", "route": "cuda",
         "source": "omega_tpu_torch/csrc/barotropic.cu",
         "replaces": "omega_tpu/ops/barotropic_kernel.py:62",
         "launches": spl_launches["barotropic"],
         "max_abs_err": splv["barotropic"]["max_abs_err"],
         "ms": splv["barotropic"]["ms"],
         "device_ms": splv["barotropic"]["device_ms"],
         "plain_ms": splv["barotropic"]["plain_ms"],
         "bound_ms": splv["barotropic"]["bound_ms"],
         "bound_by": splv["barotropic"]["bound_by"], "library_ms": None,
         "shape": f"10 x ({NY}, {NX}) in, 7 out, float32, M = {M_SPLIT} "
         "(one cooperative launch for all M)",
         "attrs": {k: splv["barotropic"][k]
                   for k in ("resident", "streamed", "call")},
         "path": "split_path"},
        {"name": "split_post", "route": "cuda",
         "source": "omega_tpu_torch/csrc/split.cu",
         "replaces": "omega_tpu/ops/megastep.py:831",
         "launches": spl_launches["split_post"],
         "max_abs_err": splv["split_post"]["max_abs_err"],
         "ms": splv["split_post"]["ms"],
         "plain_ms": splv["split_post"]["plain_ms"],
         "bound_ms": splv["split_post"]["bound_ms"],
         "bound_by": splv["split_post"]["bound_by"], "library_ms": None,
         "shape": f"({CH}, {NLAYERS}, {NY}, {NX}) + (3, {NLAYERS}, {NY}, "
         f"{NX}) + 12 x ({NY}, {NX}) in, ({CH}, {NLAYERS}, {NY}, {NX}) out, "
         "float32", "path": "split_path"},
        {"name": "patch_step", "route": "cuda",
         "source": "omega_tpu_torch/csrc/patch_step_cc.cu",
         "template": "omega_tpu_torch/csrc/patch_step.cuh",
         "replaces": "omega_tpu/ops/patch_megastep.py:1218",
         "call_site": "omega_tpu/ops/patch_megastep.py:1425",
         "launches": sph_launches["patch_step"],
         "max_abs_err": patv["max_abs_err"], "ms": patv["ms"],
         "plain_ms": patv["plain_ms"], "bound_ms": patv["bound_ms"],
         "bound_by": patv["bound_by"], "library_ms": None,
         "shape": f"frames {tuple(patv['frames'])} float32 (icos"
         f"{N_SPHERE}, S = {p48.S}), kind fb, flagship",
         "passes_per_call": patch_megastep.PASSES, "path": "sphere_path",
         "driver_sphere_launches": driver_launches["patch_step"],
         "coastal_patch_path_launches": cp_launches["patch_step"],
         "patch_sharded_path_launches": ps_launches["patch_step"],
         "patch_sharded_path_launches_per_step_per_shard":
             ps_launches["patch_step"] / nsh / 5},
        {"name": "patch_step_science", "route": "cuda",
         "source": "omega_tpu_torch/csrc/patch_step_uu.cu",
         "template": "omega_tpu_torch/csrc/patch_step.cuh",
         "replaces": "omega_tpu/ops/patch_megastep.py:1218",
         "call_site": "omega_tpu/ops/patch_megastep.py:1425",
         "chain": "omega_tpu/mesh/icos_mega.py:457 _pre_ops (upwind), :568 "
         "_phys_ops (wind, drag)",
         "launches": ss_launches["patch_step"],
         "max_abs_err": sciv["upwind_wind_drag_pp81"]["step_max_abs_err"],
         "ms": sciv["step_ms"], "plain_ms": sciv["step_plain_ms"],
         "bound_ms": sciv["bound_ms"]["horizontal"],
         "bound_by": sciv["bound_by"]["horizontal"], "library_ms": None,
         "shape": f"frames {tuple(patv['frames'])} + wind (3, {p48.P}) "
         f"float32 (icos{N_SPHERE}), upwind fluxes, wind and drag",
         "passes_per_call": patch_megastep.PASSES,
         "path": "sphere_science_path"},
        {"name": "patch_pp81_coeffs", "route": "cuda",
         "source": "omega_tpu_torch/csrc/patch_vmix.cu",
         "replaces": "omega_tpu/ops/patch_megastep.py:1218",
         "chain": "omega_tpu/mesh/icos_mega.py:582 _vmix_ops (pp81), "
         "omega_tpu/ops/patch_megastep.py:950-990",
         "launches": ss_launches["patch_coeffs"],
         "max_abs_err": sciv["upwind_wind_drag_pp81"]["coeffs_max_abs_err"],
         "ms": sciv["coeffs_ms"], "plain_ms": sciv["coeffs_plain_ms"],
         "bound_ms": sciv["bound_ms"]["coeffs"],
         "bound_by": sciv["bound_by"]["coeffs"], "library_ms": None,
         "frame_bound_ms": sciv["bound_ms"]["coeffs_frames"],
         "attrs": sciv["coeffs_attrs"],
         "shape": f"frames {tuple(patv['frames'])} -> ({NLAYERS}, 4, "
         f"{p48.P}) float32", "path": "sphere_science_path"},
        {"name": "patch_vmix_solve", "route": "cuda",
         "source": "omega_tpu_torch/csrc/patch_vmix.cu",
         "shared": "omega_tpu_torch/csrc/column_solve.cuh",
         "replaces": "omega_tpu/ops/patch_megastep.py:1218",
         "chain": "omega_tpu/ops/patch_megastep.py:932-948 (vmix_u, vmix_c, "
         "vmix_u_arr, vmix_c_arr), omega_tpu/ops/megastep.py:360 "
         "_pcr_diffusion",
         "launches": ss_launches["patch_solve"],
         "max_abs_err": sciv["upwind_wind_drag_pp81"][
             "solve_upwind_wind_drag_pp81"]["max_abs_err"],
         "ms": sciv["solve_ms"]["pp81"],
         "plain_ms": sciv["solve_plain_ms_pp81"],
         "bound_ms": sciv["bound_ms"]["solve"],
         "bound_by": sciv["bound_by"]["solve"], "library_ms": None,
         "shape": f"frames {tuple(patv['frames'])} in place, PP81 "
         "coefficients, float32", "path": "sphere_science_path",
         "constant_coefficients_ms": sciv["solve_ms"]["constant"]},
        {"name": "patch_fct_a", "route": "cuda",
         "source": "omega_tpu_torch/csrc/patch_step_cf.cu",
         "template": "omega_tpu_torch/csrc/patch_step.cuh",
         "replaces": "omega_tpu/ops/patch_megastep.py:1218",
         "call_site": "omega_tpu/ops/patch_megastep.py:1425",
         "chain": "omega_tpu/mesh/icos_mega.py:714 fct_stage_a_chain "
         "(kind fcta)",
         "launches": sf_launches["patch_fct_a"],
         "max_abs_err": fcv["stage_a_max_abs_err"], "ms": fcv["stage_a_ms"],
         "plain_ms": fcv["stage_a_plain_ms"],
         "bound_ms": fcv["stage_a_bound_ms"],
         "bound_by": fcv["stage_a_bound_by"], "library_ms": None,
         "shape": f"frames {tuple(patv['frames'])} -> ({NLAYERS}, "
         f"{4 + 2 * NTRACERS}, {p48.P}) float32, center thickness flux",
         "passes_per_call": patch_megastep.PASSES,
         "path": "sphere_fct_path"},
        {"name": "patch_fct_b", "route": "cuda",
         "source": "omega_tpu_torch/csrc/patch_fct.cu",
         "replaces": "omega_tpu/ops/patch_megastep.py:1218",
         "call_site": "omega_tpu/ops/patch_megastep.py:1425",
         "chain": "omega_tpu/mesh/icos_mega.py:757 fct_stage_b_chain "
         "(kind fctb)",
         "launches": sf_launches["patch_fct_b"],
         "max_abs_err": fcv["stage_b_max_abs_err"], "ms": fcv["stage_b_ms"],
         "plain_ms": fcv["stage_b_plain_ms"],
         "bound_ms": fcv["stage_b_bound_ms"],
         "bound_by": fcv["stage_b_bound_by"], "library_ms": None,
         "shape": f"({NLAYERS}, {4 + 2 * NTRACERS}, {p48.P}) + frames "
         f"{tuple(patv['frames'])} -> tracers, float32, center thickness "
         "flux", "passes_per_call": patch_megastep.FCT_B_PASSES,
         "passes": fcv["stage_b_passes"], "path": "sphere_fct_path"},
        {"name": "patch_rk", "route": "cuda",
         "source": "omega_tpu_torch/csrc/patch_rk_cc.cu",
         "template": "omega_tpu_torch/csrc/patch_rk.cuh",
         "replaces": "omega_tpu/ops/patch_megastep.py:1218",
         "call_site": "omega_tpu/ops/patch_megastep.py:1425",
         "kinds": "rk2a, rk2b, rk4s1-rk4s4",
         "chain": "omega_tpu/mesh/icos_mega.py:822 rk2_stage_chain, :857 "
         "rk4_stage_chain",
         "launches": rk4s_launches["patch_rk"],
         "max_abs_err": rkpv["cc"]["mid"]["max_abs_err"],
         "ms": rkpv["cc"]["mid"]["ms"],
         "plain_ms": rkpv["cc"]["mid"]["plain_ms"],
         "bound_ms": rkpv["cc"]["mid"]["bound_ms"],
         "bound_by": rkpv["cc"]["mid"]["bound_by"], "library_ms": None,
         "shape": f"mode mid: 3 x frames {tuple(patv['frames'])} in, 2 out, "
         "float32, center fluxes, no tails",
         "modes_ms": {c: rkpv["cc"][c]["ms"] for c in RK_CASES},
         "modes_bound_ms": {c: rkpv["cc"][c]["bound_ms"] for c in RK_CASES},
         "rk4_step_stages_ms": rkpv["rk4_stages_ms"],
         "rk4_step_bound_ms": rkpv["rk4_step_bound_ms"],
         "passes_per_call": patch_megastep.RK_PASSES,
         "passes": rkpv["cc"]["passes"],
         "path": "sphere_rk4_path"},
        {"name": "patch_rk_science", "route": "cuda",
         "source": "omega_tpu_torch/csrc/patch_rk_uu.cu",
         "template": "omega_tpu_torch/csrc/patch_rk.cuh",
         "replaces": "omega_tpu/ops/patch_megastep.py:1218",
         "call_site": "omega_tpu/ops/patch_megastep.py:1425",
         "kinds": "rk2a, rk2b",
         "chain": "omega_tpu/mesh/icos_mega.py:822 rk2_stage_chain (upwind, "
         "wind, drag)",
         "launches": rk2s_launches["patch_rk"],
         "max_abs_err": rkpv["uu_wind_drag"]["prov_b"]["max_abs_err"],
         "ms": rkpv["uu_wind_drag"]["prov_b"]["ms"],
         "plain_ms": rkpv["uu_wind_drag"]["mid"]["plain_ms"],
         "plain_ms_mode": "mid",
         "bound_ms": rkpv["uu_wind_drag"]["prov_b"]["bound_ms"],
         "bound_by": rkpv["uu_wind_drag"]["prov_b"]["bound_by"],
         "library_ms": None,
         "shape": f"mode prov: 2 x frames {tuple(patv['frames'])} + wind "
         f"(3, {p48.P}) in, 1 out, float32, upwind fluxes, wind and drag",
         "modes_ms": {c: rkpv["uu_wind_drag"][c]["ms"] for c in RK_CASES},
         "rk2_step_stages_ms": rkpv["rk2_science_stages_ms"],
         "rk2_step_bound_ms": rkpv["rk2_step_bound_ms"],
         "passes_per_call": patch_megastep.RK_PASSES,
         "passes": rkpv["uu_wind_drag"]["passes"],
         "path": "sphere_rk2_path"},
        {"name": "patch_split_pre", "route": "cuda",
         "source": "omega_tpu_torch/csrc/patch_split.cu",
         "template": "omega_tpu_torch/csrc/patch_rk.cuh",
         "replaces": "omega_tpu/ops/patch_megastep.py:1218",
         "call_site": "omega_tpu/ops/patch_megastep.py:1411",
         "kinds": "splitpre",
         "chain": "omega_tpu/mesh/icos_mega.py:645 split_pre_chain",
         "launches": sps_launches["patch_split_pre"],
         "max_abs_err": sptv["split_pre_max_abs_err"],
         "ms": sptv["split_pre_ms"], "plain_ms": sptv["split_pre_plain_ms"],
         "bound_ms": sptv["split_pre_bound_ms"],
         "bound_by": sptv["split_pre_bound_by"], "library_ms": None,
         "shape": f"frames {tuple(patv['frames'])} in, du_out ({NLAYERS}, "
         f"3, {p48.P}) out, float32, center fluxes, column ssh",
         "passes_per_call": patch_megastep.SPLIT_PRE_PASSES,
         "passes": sptv["split_pre_passes"],
         "path": "sphere_split_path"},
        {"name": "bt_gather", "route": "cuda",
         "source": "omega_tpu_torch/csrc/bt_gather.cu",
         "replaces": "omega_tpu/ops/patch_megastep.py:2205",
         "replaces_note": "the reference's lax.scan of the barotropic "
         "subcycles (not a Pallas site); the planar Pallas counterpart is "
         "omega_tpu/ops/barotropic_kernel.py:62",
         "launches": sps_launches["bt_gather"],
         "max_abs_err": max(sptv[f"bt_drag_{r}"]["max_abs_err"]
                            for r in (0.0, 1e-4)),
         "ms": sptv["bt_ms"], "device_ms": sptv["bt_device_ms"],
         "plain_ms": sptv["bt_plain_ms"],
         "bound_ms": sptv["bt_bound_ms"], "bound_by": sptv["bt_bound_by"],
         "library_ms": None,
         "shape": f"({m48.nedges}, 1) x 3 + ({m48.ncells}, 1) in, 3 out, "
         f"float32, M = {M_SPLIT} (one cooperative launch for all M)",
         "subcycle_bound_ms": sptv["bt_subcycle_bound_ms"],
         "attrs": sptv["bt_attrs"],
         "gather_split_launches_per_step": {
             k: gsp[k]["launches_per_step"]["bt_gather"]
             for k in ("gather", "coastal")},
         "path": "sphere_split_path"},
        {"name": "patch_split_post", "route": "cuda",
         "source": "omega_tpu_torch/csrc/patch_split.cu",
         "template": "omega_tpu_torch/csrc/patch_step.cuh",
         "replaces": "omega_tpu/ops/patch_megastep.py:1218",
         "call_site": "omega_tpu/ops/patch_megastep.py:1413",
         "kinds": "splitpost",
         "chain": "omega_tpu/mesh/icos_mega.py:659 split_post_chain",
         "launches": sps_launches["patch_split_post"],
         "max_abs_err": sptv["split_post_max_abs_err"],
         "ms": sptv["split_post_ms"],
         "plain_ms": sptv["split_post_plain_ms"],
         "bound_ms": sptv["split_post_bound_ms"],
         "bound_by": sptv["split_post_bound_by"], "library_ms": None,
         "shape": f"frames {tuple(patv['frames'])} in, h and tracers of "
         "the next frames out, float32, center fluxes",
         "passes_per_call": patch_megastep.SPLIT_POST_PASSES,
         "path": "sphere_split_path"},
        {"name": "gather", "route": "cuda",
         "source": "omega_tpu_torch/csrc/gather.cu",
         "replaces": "omega_tpu/ops/pallas_gather.py:113",
         "call_site": "omega_tpu/ops/pallas_gather.py:160",
         "launches": gp["launches"]["gather"],
         "max_abs_err": gtab["tang_L2"]["max_abs_err"],
         "max_rel_err_all_tables": gth["f32_icos48_x100"],
         "ms": gtab["tang_L2"]["ms"], "plain_ms": gtab["tang_L2"]["plain_ms"],
         "bound_ms": gtab["tang_L2"]["bound_ms"],
         "bound_by": gtab["tang_L2"]["bound_by"],
         "library_ms": gtab["tang_L2"]["library_ms"],
         "library": "torch.sparse.mm, the table as a block-diagonal CSR "
         "matrix (cuSPARSE SpMM)",
         "shape": f"tang: (2, {g48_np.nedges}, {NLAYERS}) in, "
         f"(2, {g48_np.nedges}, {NLAYERS}) out, 12 slots, float32",
         "path": "gather_path",
         "fb_step_sums_ms": {q: gth[f"fb_step_{q}"] for q in
                             ("ms", "plain_ms", "library_ms", "bound_ms")},
         "launches_per_step": gp["gather_launches_per_step"],
         "coastal_launches": cg["launches"]["gather"],
         "slower_than_library": gth["slower_than_library"],
         "per_table": {k: {q: v[q] for q in ("ms", "spread_ms",
                                             "plain_ms", "library_ms",
                                             "bound_ms", "max_abs_err")}
                       for k, v in gtab.items()}},
    ], "seconds": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


def composed(stepper, *args, **kw):
    """A stepper's composed path (the stencil-kernel path; on a patch mesh
    the patch operators) on the card: the stepper runs with the fused
    kernels', the two barotropic kernels' and the patch step's dispatch
    turned away (the subcycles the plain loop)."""
    from omega_tpu_torch.ops import barotropic_kernel as btk
    from omega_tpu_torch.ops import bt_gather, megastep, patch_megastep
    mods = (megastep, btk, bt_gather, patch_megastep)
    keep = [m.enabled for m in mods]
    for m in mods:
        m.enabled = lambda x: False
    try:
        return stepper(*args, **kw)
    finally:
        for m, k in zip(mods, keep):
            m.enabled = k


def _composed_step(mesh, cfg, state, dt, wind_stress=None):
    """One composed forward-backward step (the stencil-kernel path), going
    around the stepper's dispatch to the fused kernel. Horizontal terms
    only: what the fused horizontal kernel is held against."""
    from omega_tpu_torch.core import tendencies as tend
    from omega_tpu_torch.core.state import ModelState
    h, u, tr = state
    dh, thick = tend.compute_thickness_tendency(mesh, cfg, h, u, 0.0)
    h_new = h + dt * dh
    dtr, _ = tend.compute_tracer_tendency(mesh, cfg, h, u, tr,
                                          thick.mean_h_edge, 0.0,
                                          h_new=h_new, dt=dt,
                                          flux_h_edge=thick.flux_h_edge)
    tr_new = (tr * h[None] + dt * dtr) / h_new[None]
    du, _ = tend.compute_velocity_tendency(mesh, cfg, h_new, u, dt,
                                           wind_stress)
    return ModelState(h=h_new, u=u + dt * du, tracers=tr_new)


def _spmm_operand(idx, w, nsrc, L, dev, dtype):
    """The library call's operand for a stencil (idx, w) with `nsrc` source
    rows: the (L n, L nsrc) block-diagonal CSR matrix of its nonzero-weight
    slots, which torch.sparse.mm applies to a field of L leading indices
    seen as (L nsrc, K)."""
    import numpy as np
    import torch
    idx = np.asarray(idx, np.int64)
    w = np.asarray(w, np.float64)
    n = idx.shape[0]
    nz = w != 0.0
    rows = np.broadcast_to(np.arange(n)[:, None], idx.shape)[nz]
    rows = np.concatenate([rows + b * n for b in range(L)])
    cols = np.concatenate([idx[nz] + b * nsrc for b in range(L)])
    vals = np.tile(w[nz], L)
    A = torch.sparse_coo_tensor(np.stack([rows, cols]), vals,
                                (L * n, L * nsrc)).coalesce()
    return A.to_sparse_csr().to(device=dev, dtype=dtype)


def _spmm_check(lib_out, ref, name):
    """The library call computes the same function: within 1e-5 of the
    largest value (float32 sums in another order). Returns the error."""
    err = ((lib_out.reshape(ref.shape) - ref).abs().max()
           / ref.abs().max().clamp_min(1e-30)).item()
    if not err <= 1e-5:
        raise RuntimeError(f"torch.sparse.mm of {name} disagrees with the "
                           f"kernel by {err} of max|ref|")
    return err


def _gather_bytes_flops(table, L, K, itemsize=4):
    """A gather pass's least work, from this run's table (as
    port_bounds.gather counts it): the field read and the output written
    once per leading index, the table as CSR (its nonzero-weight entries,
    an int32 column and a weight each, and n + 1 int32 row offsets) read
    once; two operations per entry per layer."""
    nnz = int((table.w[:table.n] != 0.0).sum())
    nbytes = (L * (table.nsrc + table.n) * K * itemsize
              + nnz * (4 + itemsize) + (table.n + 1) * 4)
    return nbytes, 2 * nnz * K * L


def _fb_flops_per_point(tabs, ntracers, fct=False):
    """Floating-point operations of the FB chain per (cell, layer): two per
    table entry applied, plus the pointwise arithmetic between levels. (The
    RK stage's chain, every aux at one level, is within a few operations of
    it.)"""
    n = lambda *names: sum(len(tabs[k]) for k in names)
    thick = 2 * n("cmean", "div") + 5
    # (the upwind and tail variants cost within a few operations of this)
    tracer = 2 * n("cmean", "div", "cdiff", "signed_div", "cdiff",
                   "signed_div") + 24
    if fct:
        # the low-order flux's divergence, four budget walks, the
        # corrected flux's divergence, 24 min / max of the bounds and the
        # pointwise limiter, in place of the centered flux
        tracer += 2 * (n("div", "div_pos", "div_neg", "div_pos", "div_neg")
                       - n("cmean")) + 24 + 60
    vel = 2 * (n("ke", "div", "curl", "kite", "vmean", "vmean", "cdiff",
                 "vdiff", "div", "curl", "cmean", "tang", "tang", "cdiff",
                 "cdiff", "cdiff", "vdiff")) + 90
    return thick + ntracers * tracer + vel


def _split_flops_per_point(tabs, ntracers):
    """Floating-point operations per (cell, layer) of splitpre and
    splitpost, and per cell of one barotropic subcycle: two per table entry
    applied, plus the pointwise arithmetic. splitpre: the column sums (three
    cmean, three products, seven adds), the momentum chain (the FB chain's
    velocity part and its cmean of h), the depth average of du_full (three
    cmean, three products and adds). splitpost: the FB chain's thickness and
    tracer parts and u_new (twelve operations)."""
    n = lambda *names: sum(len(tabs[k]) for k in names)
    columns = 2 * n("cmean") + 3 + 7
    chain = _fb_flops_per_point(tabs, 0) - 2 * n("div") - 5
    average = 2 * n("cmean") + 6
    post = _fb_flops_per_point(tabs, ntracers) \
        - (_fb_flops_per_point(tabs, 0) - 2 * n("cmean", "div") - 5) + 12
    # ub_new: cdiff, tang and 7 operations per class; het * ub, div, the
    # ssh update and the average's add
    bt = 2 * n("cdiff", "tang") + 21 + 3 + 2 * n("div") + 2 + 3
    return columns + chain + average, bt, post


if __name__ == "__main__":
    sys.exit(main())
