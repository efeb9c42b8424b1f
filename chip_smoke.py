#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (omega_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, as a release check
    python3 chip_smoke.py --tiles 16x16,32x32@256     # also time those tiles

It builds the CUDA kernels from omega_tpu_torch/csrc, holds each kernel
against its plain PyTorch version on the card, drives the port's main path
(256 x 256 cells x 100 layers x 2 tracers, float32, forward-backward
stepper) through the entry points a user calls, and prints one JSON line
per phase:

  device          the card, and nvidia-smi's name / power-limit line
  build           nvcc build of the kernels, seconds
  kernel_stencil  structured-stencil kernel vs plain, every table
  kernel_fb_step  fused FB step vs plain and vs the composed step
  main_path       2 x 20 steps of the bench configuration; launch counts
  composed_path   upwind thickness flux: the composed stepper + stencil kernel
  profile         (only with --profile) device time by kernel, both paths
  kernels         both kernels: launches, max error, times, bounds

Any failed check raises, so the exit code is non-zero and the closing line
is never printed. Needs a CUDA device; imports nothing of JAX.
"""

import argparse
import json
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
    ap.add_argument("--tiles", default="",
                    help="extra fused-kernel tiles to time, as ROWSxCOLS or "
                    "ROWSxCOLS@THREADS, e.g. 16x16,32x32@256")
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
                                      TendencyConfig)
    from omega_tpu_torch.mesh import planar_hex_mesh
    from omega_tpu_torch.ops import (_build, megastep, stencil_kernel,
                                     structured)
    from omega_tpu_torch.stepping import forward_backward_step, run_steps

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
          "ptxas": regs[:24]})

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
    # (K = 5 takes the kernel's one-element path, K = 4 and 100 its
    # 16-byte path)
    for (nx, ny, K, dtype, tol) in ((16, 8, 5, torch.float64, 1e-12),
                                    (48, 20, 5, torch.float64, 1e-12),
                                    (24, 12, 4, torch.float64, 1e-12),
                                    (16, 8, 5, torch.float32, 1e-5),
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
                f = rand(lead + (ps * nx * ny, K), dtype)
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
            if dtype == torch.float32:
                tables[key[3]] = {"max_abs_err": worst}
                stencil_err_f32 = max(stencil_err_f32, worst)
    # times at the shapes the composed step gives them
    mesh32 = mesh_on_card(NX, NY, torch.float32)
    C = NX * NY
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
        b_ms, b_by = bound((ps + pd) * nb * C * NLAYERS * 4,
                           2 * len(tab) * nb * C * NLAYERS)
        timed[name] = {"lead": list(lead), "ms": ms, "plain_ms": plain,
                       "bound_ms": b_ms, "bound_by": b_by}
        tables[name].update(timed[name])
        del f
    emit({"phase": "kernel_stencil", "tables": tables,
          "max_abs_err_f32": stencil_err_f32,
          "tolerance": "f64 atol 1e-12; f32 1e-5 of max|ref|"})

    # -------------------------------------------------- 4. kernel_fb_step
    def bench_cfg(K, L, **kw):
        return ModelConfig(nvertlayers=K, ntracers=L,
                           tendencies=TendencyConfig(visc_del2=1.0e3,
                                                     visc_del4=1.0e9), **kw)

    def noisy_state(mesh_np, K, L, dtype):
        kx = 2 * np.pi / mesh_np.x_period
        ky = 2 * np.pi / mesh_np.y_period
        ssh = np.sin(kx * mesh_np.x_cell) * np.sin(ky * mesh_np.y_cell)
        h = (1000.0 + ssh[:, None]) / K * np.ones((1, K))
        put = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
        return ModelState(
            h=put(h),
            u=put(0.01 * rng.standard_normal((mesh_np.nedges, K))),
            tracers=put(10.0 + rng.standard_normal((L, mesh_np.ncells, K))))

    def nerr(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    fb = {"f64": {}, "tolerance": "f64 rtol=atol=1e-10 over 3 steps; f32 "
          "max|diff|/max|ref| <= 1e-4 after 1 step (FMA contraction and "
          "another summation order than the plain version)"}
    for (nx, ny, K) in ((32, 16, 3), (48, 20, 5)):
        mesh_np = planar_hex_mesh(nx, ny, dc=5000.0, f0=1e-4,
                                  bottom_depth=1000.0)
        mesh = mesh_np.to(dev, torch.float64)
        cfg = bench_cfg(K, NTRACERS)
        if not megastep.supported(mesh, cfg):
            fail("flagship configuration not supported by the fused kernel")
        st = noisy_state(mesh_np, K, NTRACERS, torch.float64)
        ker = pla = megastep.stack_state(mesh, st)
        comp = st
        for _ in range(3):
            ker = megastep.fb_megastep_stacked(mesh, cfg, ker, DT)
            pla = megastep.fb_megastep_plain(mesh, cfg, pla, DT)
            comp = _composed_step(mesh, cfg, comp, DT)
        torch.cuda.synchronize()
        comp_s = megastep.stack_state(mesh, comp)
        worst = {}
        for what, ref in (("plain", pla), ("composed", comp_s)):
            d = (ker - ref).abs()
            bad = d > 1e-10 + 1e-10 * ref.abs()
            if bool(bad.any()) or not bool(torch.isfinite(ker).all()):
                fail(f"fused FB kernel vs {what} at {nx}x{ny}x{K} f64: "
                     f"max abs diff {d.max().item()}")
            worst[what] = d.max().item()
        fb["f64"][f"{nx}x{ny}x{K}"] = worst

    mesh_np = planar_hex_mesh(NX, NY, dc=5000.0, f0=1e-4, bottom_depth=1000.0)
    mesh32 = mesh_np.to(dev, torch.float32)
    cfg = bench_cfg(NLAYERS, NTRACERS)
    st = noisy_state(mesh_np, NLAYERS, NTRACERS, torch.float32)
    s0 = megastep.stack_state(mesh32, st)
    ker = megastep.fb_megastep_stacked(mesh32, cfg, s0, DT)
    pla = megastep.fb_megastep_plain(mesh32, cfg, s0, DT)
    comp_s = megastep.stack_state(mesh32, _composed_step(mesh32, cfg, st, DT))
    torch.cuda.synchronize()
    if not bool(torch.isfinite(ker).all()):
        fail("fused FB kernel: non-finite output at full width")
    fb_abs_err = (ker - pla).abs().max().item()
    f32 = {}
    for what, ref in (("plain", pla), ("composed", comp_s)):
        errs = {"h": nerr(ker[0], ref[0]), "u": nerr(ker[1:4], ref[1:4]),
                "tracers": nerr(ker[4:], ref[4:])}
        if max(errs.values()) > 1e-4:
            fail(f"fused FB kernel vs {what} at full width f32: {errs}")
        f32[what] = errs
    del pla, comp_s
    CH = 4 + NTRACERS
    buf = [s0, ker]

    def step_pingpong(tile=None):
        megastep.fb_megastep_stacked(mesh32, cfg, buf[0], DT, out=buf[1],
                                     tile=tile)
        buf.reverse()

    fb_ms = cuda_ms(step_pingpong, 20)
    buf[0].copy_(megastep.stack_state(mesh32, st))
    fb_plain_ms = cuda_ms(
        lambda: megastep.fb_megastep_plain(mesh32, cfg, buf[0], DT), 3, 1)
    tabs, _ = megastep._mega_args(mesh32, cfg, DT)
    plan = megastep.plan_tile(NY, NX, 4, megastep.chain_radius(tabs))
    fb_bound_ms, fb_bound_by = bound(
        2 * CH * NLAYERS * C * 4,
        _fb_flops_per_point(tabs, NTRACERS) * NLAYERS * C)
    tile_ms = {}
    for spec in filter(None, args.tiles.split(",")):
        dims, _, thr = spec.partition("@")
        tile = tuple(int(v) for v in dims.split("x")) \
            + ((int(thr),) if thr else ())
        buf[0].copy_(megastep.stack_state(mesh32, st))
        tile_ms[spec] = cuda_ms(lambda: step_pingpong(tile), 10)
    fb.update({"f32_256x256x100x2": f32, "max_abs_err": fb_abs_err,
               "ms": fb_ms, "plain_ms": fb_plain_ms, "bound_ms": fb_bound_ms,
               "bound_by": fb_bound_by, "plan": plan, "tile_ms": tile_ms})
    emit({"phase": "kernel_fb_step", **fb})
    del buf, s0, ker, st

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

    vol0, trc0 = content(state)
    nseg, seg = 2, 20
    megastep.launches = 0
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
    if main_launches["stencil"] != 0:
        fail("main path: the stencil kernel ran inside the fused path")
    ms_step = seg_s[-1] / seg * 1e3
    emit({"phase": "main_path", "config": f"{NX}x{NY}x{NLAYERS}x{NTRACERS} "
          "float32 dc=5000 f0=1e-4 dt=30 visc_del2=1e3 visc_del4=1e9",
          "steps": nseg * seg, "segment_seconds": seg_s,
          "ms_per_step": ms_step,
          "gridpoint_steps_per_s": C * NLAYERS / (ms_step * 1e-3),
          "volume_drift": vol_drift, "tracer_drift": trc_drift,
          "max_abs_u": umax, "launches": main_launches})

    # --------------------------------------------------- 6. composed_path
    # upwind thickness flux is not taken by the fused kernel: the composed
    # stepper runs, and every stencil pass goes through the stencil kernel
    cfg_up = bench_cfg(NLAYERS, NTRACERS, flux_thickness_type="upwind")
    if megastep.supported(mesh, cfg_up):
        fail("upwind configuration unexpectedly taken by the fused kernel")
    nup = 3
    run_steps(mesh, cfg_up, state, 0.0, DT, 1)       # untimed first step
    megastep.launches = 0
    stencil_kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_steps(mesh, cfg_up, state, 0.0, DT, nup,
                    stepper=forward_backward_step)
    torch.cuda.synchronize()
    up_ms = (time.perf_counter() - t0) / nup * 1e3
    comp_launches = {"fb_step": megastep.launches,
                     "stencil": stencil_kernel.launches}
    if not all(bool(torch.isfinite(x).all()) for x in out):
        fail("composed path: non-finite state")
    if comp_launches["stencil"] <= 0 or comp_launches["fb_step"] != 0:
        fail(f"composed path: launches {comp_launches}")
    emit({"phase": "composed_path", "steps": nup, "ms_per_step": up_ms,
          "stencil_launches_per_step": comp_launches["stencil"] / nup,
          "launches": comp_launches})

    # ------------------------------------------------- optional: profile
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

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
                  mesh, cfg_up, state, 0.0, DT, 2))})

    # ---------------------------------------------------------- 7. kernels
    print(smi_line, flush=True)
    emit({"kernels": [
        {"name": "fb_step", "route": "cuda",
         "source": "omega_tpu_torch/csrc/fb_step.cu",
         "replaces": "omega_tpu/ops/megastep.py:880",
         "launches": main_launches["fb_step"], "max_abs_err": fb_abs_err,
         "ms": fb_ms, "plain_ms": fb_plain_ms, "bound_ms": fb_bound_ms,
         "bound_by": fb_bound_by, "library_ms": None,
         "shape": f"({CH}, {NLAYERS}, {NY}, {NX}) float32",
         "path": "main_path"},
        {"name": "stencil", "route": "cuda",
         "source": "omega_tpu_torch/csrc/stencil.cu",
         "replaces": "omega_tpu/ops/pallas_stencil_dma.py:55",
         "also_replaces": "omega_tpu/ops/pallas_stencil.py:74",
         "launches": comp_launches["stencil"],
         "max_abs_err": stencil_err_f32,
         "ms": timed["tang"]["ms"], "plain_ms": timed["tang"]["plain_ms"],
         "bound_ms": timed["tang"]["bound_ms"],
         "bound_by": timed["tang"]["bound_by"], "library_ms": None,
         "shape": f"tang on (2, {3 * C}, {NLAYERS}) float32",
         "path": "composed_path", "per_table": timed},
    ], "seconds": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


def _composed_step(mesh, cfg, state, dt):
    """One composed forward-backward step (the stencil-kernel path), going
    around the stepper's dispatch to the fused kernel."""
    from omega_tpu_torch.core import tendencies as tend
    from omega_tpu_torch.core.state import ModelState
    h, u, tr = state
    dh, thick = tend.compute_thickness_tendency(mesh, cfg, h, u, 0.0)
    h_new = h + dt * dh
    dtr, _ = tend.compute_tracer_tendency(mesh, cfg, h, u, tr,
                                          thick.mean_h_edge, 0.0)
    tr_new = (tr * h[None] + dt * dtr) / h_new[None]
    du, _ = tend.compute_velocity_tendency(mesh, cfg, h_new, u, dt)
    return ModelState(h=h_new, u=u + dt * du, tracers=tr_new)


def _fb_flops_per_point(tabs, ntracers):
    """Floating-point operations of the FB chain per (cell, layer): two per
    table entry applied, plus the pointwise arithmetic between levels."""
    n = lambda *names: sum(len(tabs[k]) for k in names)
    thick = 2 * n("cmean", "div") + 5
    tracer = 2 * n("cmean", "div", "cdiff", "signed_div", "cdiff",
                   "signed_div") + 24
    vel = 2 * (n("ke", "div", "curl", "kite", "vmean", "vmean", "cdiff",
                 "vdiff", "div", "curl", "cmean", "tang", "tang", "cdiff",
                 "cdiff", "cdiff", "vdiff")) + 90
    return thick + ntracers * tracer + vel


if __name__ == "__main__":
    sys.exit(main())
