#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (omega_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, as a release check
    python3 chip_smoke.py --tiles 16x16,32x32@256     # also time those tiles
    python3 chip_smoke.py --solve-columns 4,16,32     # also time the column
                                    # solve with those many columns per block

It builds the CUDA kernels from omega_tpu_torch/csrc, holds each kernel
against its plain PyTorch version on the card, drives the port's main paths
(256 x 256 cells x 100 layers x 2 tracers, float32, forward-backward
stepper) through the entry points a user calls, and prints one JSON line
per phase:

  device          the card, and nvidia-smi's name / power-limit line
  build           nvcc build of the kernels, seconds
  kernel_stencil  structured-stencil kernel vs plain, every table
  kernel_fb_step  fused FB step vs plain and vs the composed step, for the
                  flagship chain and its variants (upwind fluxes, wind, drag)
  kernel_vmix     PP81 coefficient kernel and column-solve kernel vs plain
  main_path       2 x 10 steps of the bench configuration; launch counts
  composed_path   FCT tracer flux: the composed stepper + stencil kernel
  science_path    2 x 10 steps with wind, bottom drag, upwind fluxes and PP81
                  vertical mixing: three kernel launches per step
  profile         (only with --profile) device time by kernel, every path
  kernels         every kernel: launches, max error, times, bounds

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
    ap.add_argument("--solve-columns", default="",
                    help="extra column-group widths of the vertical-mixing "
                    "solve kernel to time (the module has one, "
                    "vmix_kernel.SOLVE_COLUMNS), e.g. 4,16,32")
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
                                          bottom_drag_coeff=3.0e-3))}
    FULL_WIDTH = ("flagship", "upwind", "wind_drag", "upwind_wind_drag")

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

    def wind_of(mesh_np, dtype):
        """A zonal stress that varies in y and a uniform meridional one."""
        ky = 2 * np.pi / mesh_np.y_period
        return (put(0.1 * np.sin(ky * mesh_np.y_cell), dtype),
                put(0.05 * np.ones(mesh_np.ncells), dtype))

    def nerr(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    fb = {"f64": {}, "tolerance": "f64 rtol=atol=1e-10 over 3 steps; f32 "
          "max|diff|/max|ref| <= 1e-4 after 1 step (FMA contraction and "
          "another summation order than the plain version), and each "
          "tracer's error <= 0.05 of the most the step changed it"}
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

        def step_pingpong(tile=None):
            megastep.fb_megastep_stacked(mesh32, cfg_v, buf[0], DT,
                                         out=buf[1], tile=tile, wind=plane)
            buf.reverse()

        ms = cuda_ms(step_pingpong, 20)
        buf[0].copy_(s0)
        plain_ms = cuda_ms(lambda: megastep.fb_megastep_plain(
            mesh32, cfg_v, buf[0], DT, wind=plane), 3, 1)
        tabs, consts = megastep._mega_args(mesh32, cfg_v, DT)
        plan = megastep.plan_tile(NY, NX, 4,
                                  megastep._ring(tabs, consts, plane))
        b_ms, b_by = bound(
            (2 * CH * NLAYERS + (3 if plane is not None else 0)) * C * 4,
            _fb_flops_per_point(tabs, NTRACERS) * NLAYERS * C)
        fbv[variant] = {"f32_256x256x100x2": f32, "max_abs_err": abs_err,
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "plan": plan}
        if variant == "flagship":
            tile_ms = {}
            for spec in filter(None, args.tiles.split(",")):
                dims, _, thr = spec.partition("@")
                tile = tuple(int(v) for v in dims.split("x")) \
                    + ((int(thr),) if thr else ())
                buf[0].copy_(s0)
                tile_ms[spec] = cuda_ms(lambda: step_pingpong(tile), 10)
            fbv[variant]["tile_ms"] = tile_ms
        del buf, ker
    cfg = bench_cfg(NLAYERS, NTRACERS)
    fb.update(fbv["flagship"])
    fb["variants"] = {v: fbv[v] for v in FULL_WIDTH[1:]}
    emit({"phase": "kernel_fb_step", **fb})

    # ----------------------------------------------------- 4b. kernel_vmix
    # f64 at rtol=atol=1e-10 against the plain PCR (same arithmetic level
    # for level; only FMA contraction differs). f32 at full width: 1e-4 of
    # the largest reference value per output, as for the fused step.
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
    # other column groups, for the record: the module's constant is set for
    # the timing and put back
    columns_ms = {}
    for spec in filter(None, args.solve_columns.split(",")):
        keep = vmix_kernel.SOLVE_COLUMNS
        try:
            vmix_kernel.SOLVE_COLUMNS = int(spec)
            vmix_kernel._PARAM_CACHE.clear()
            columns_ms[spec] = cuda_ms(lambda: vmix_kernel.vmix_solve(
                mesh32, cfg_pp, work, DT, (kap, nu)), 20)
        finally:
            vmix_kernel.SOLVE_COLUMNS = keep
            vmix_kernel._PARAM_CACHE.clear()
    solve_plain_ms = cuda_ms(lambda: vmix_kernel.vmix_solve_plain(
        mesh32, cfg_pp, sv, DT, (kap, nu)), 2, 1)
    KI = NLAYERS - 1
    # reads h, 3 u, T, S; writes kappa and 3 nu; ~90 operations per point
    coeff_b_ms, coeff_b_by = bound((6 * NLAYERS + 4 * KI) * C * 4,
                                   90 * KI * C)
    # reads h, 3 u, L tracers (and the 4 coefficient planes), writes 3 u and
    # L tracers; per row and level 16 operations for the matrix and 4 per
    # right-hand side, in 4 systems with 3 + L right-hand sides in all
    levels = vmix_kernel.plan_solve(NLAYERS, NTRACERS, 4)["levels"]
    solve_flops = levels * NLAYERS * C * (4 * 16 + 4 * (3 + NTRACERS))
    solve_b = {
        "constant": bound((4 + NTRACERS + 3 + NTRACERS) * NLAYERS * C * 4,
                          solve_flops),
        "pp81": bound(((4 + NTRACERS + 3 + NTRACERS) * NLAYERS + 4 * KI)
                      * C * 4, solve_flops)}
    vmx.update({
        "coeffs": {"f32_256x256x100x2": coeff_err, "max_abs_err": coeff_abs,
                   "nu_range": spread, "ms": coeff_ms,
                   "plain_ms": coeff_plain_ms, "bound_ms": coeff_b_ms,
                   "bound_by": coeff_b_by},
        "solve": {"f32_256x256x100x2": solve, "max_abs_err": solve_abs,
                  "ms": solve_ms, "columns_ms": columns_ms,
                  "plain_ms_pp81": solve_plain_ms,
                  "bound_ms": {k: v[0] for k, v in solve_b.items()},
                  "bound_by": {k: v[1] for k, v in solve_b.items()},
                  "plan": vmix_kernel.plan_solve(NLAYERS, NTRACERS, 4)}})
    emit({"phase": "kernel_vmix", **vmx})
    del work, sv, kap_p, nu_p, s0, st

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
    nseg, seg = 2, 10
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
    # the flux-corrected tracer flux is not taken by the fused kernel: the
    # composed stepper runs, and every stencil pass goes through the stencil
    # kernel
    cfg_fct = bench_cfg(NLAYERS, NTRACERS, flux_tracer_type="fct")
    if megastep.supported(mesh, cfg_fct):
        fail("FCT configuration unexpectedly taken by the fused kernel")
    nup = 3
    run_steps(mesh, cfg_fct, state, 0.0, DT, 1)      # untimed first step
    megastep.launches = 0
    stencil_kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_steps(mesh, cfg_fct, state, 0.0, DT, nup,
                    stepper=forward_backward_step)
    torch.cuda.synchronize()
    up_ms = (time.perf_counter() - t0) / nup * 1e3
    comp_launches = {"fb_step": megastep.launches,
                     "stencil": stencil_kernel.launches}
    if not all(bool(torch.isfinite(x).all()) for x in out):
        fail("composed path: non-finite state")
    if comp_launches["stencil"] <= 0 or comp_launches["fb_step"] != 0:
        fail(f"composed path: launches {comp_launches}")
    vol2, trc2 = content(out)
    comp_drift = max([abs(vol2 - vol1) / vol1]
                     + [abs(b - a) / abs(a) for a, b in zip(trc1, trc2)])
    if comp_drift > 1e-5:
        fail(f"composed path: volume / tracer drift {comp_drift}")
    emit({"phase": "composed_path", "config": "as main_path with "
          "flux_tracer_type=fct", "steps": nup, "ms_per_step": up_ms,
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
                "pp81_coeffs": vmix_kernel.coeff_launches,
                "vmix_solve": vmix_kernel.solve_launches,
                "stencil": stencil_kernel.launches}

    vol0, trc0 = content(sci0)
    nseg, seg = 2, 10
    run_steps(mesh, cfg_sci, sci0, 0.0, DT, 1, wind_stress=wind_sci)  # untimed
    # what packing the wind plane costs: the stress is rotated onto the
    # edges through the stencil kernel, once per segment
    stencil_kernel.launches = 0
    megastep.stack_wind(mesh, cfg_sci, wind_sci, torch.float32)
    pack_stencils = stencil_kernel.launches
    megastep.launches = vmix_kernel.coeff_launches = 0
    vmix_kernel.solve_launches = stencil_kernel.launches = 0
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
        if n != nseg * seg:
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
                  mesh, cfg_fct, state, 0.0, DT, 2)),
              "science_5_steps": traced(lambda: run_steps(
                  mesh, cfg_sci, sci, 0.0, DT, 5, wind_stress=wind_sci))})

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
         f"(3, {KI}, {NY}, {NX}) float32", "path": "science_path"},
        {"name": "vmix_solve", "route": "cuda",
         "source": "omega_tpu_torch/csrc/vmix.cu",
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
                                          thick.mean_h_edge, 0.0)
    tr_new = (tr * h[None] + dt * dtr) / h_new[None]
    du, _ = tend.compute_velocity_tendency(mesh, cfg, h_new, u, dt,
                                           wind_stress)
    return ModelState(h=h_new, u=u + dt * du, tracers=tr_new)


def _fb_flops_per_point(tabs, ntracers):
    """Floating-point operations of the FB chain per (cell, layer): two per
    table entry applied, plus the pointwise arithmetic between levels."""
    n = lambda *names: sum(len(tabs[k]) for k in names)
    thick = 2 * n("cmean", "div") + 5
    # (the upwind and tail variants cost within a few operations of this)
    tracer = 2 * n("cmean", "div", "cdiff", "signed_div", "cdiff",
                   "signed_div") + 24
    vel = 2 * (n("ke", "div", "curl", "kite", "vmean", "vmean", "cdiff",
                 "vdiff", "div", "curl", "cmean", "tang", "tang", "cdiff",
                 "cdiff", "cdiff", "vdiff")) + 90
    return thick + ntracers * tracer + vel


if __name__ == "__main__":
    sys.exit(main())
