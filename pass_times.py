#!/usr/bin/env python3
"""Device time of the planar splitpre's passes and splitpost, of the
sphere's FCT stage B and its launches, of the two PP81 coefficient kernels,
of the two barotropic subcycle kernels, of the structured stencil kernel's
passes, and host time per step of the sphere's forward-backward path, on
one NVIDIA GPU.

    python3 pass_times.py            # from the root of a checkout
    python3 pass_times.py fct_b      # only the parts named (split, fct_b,
                                     # pp81, bt, stencil, sphere); ptxas
                                     # always

Runs on the checkout it is started from, so that two checkouts (a commit
and the one before it) can be read in turn on one card: it reads only
what both have. Prints one JSON line per part, and the card's name and
power limit first:

  ptxas       registers, stack and spill of every kernel of csrc/split.cu,
              as nvcc's -Xptxas -v reported them at the build
  split_pre   splitpre at 256 x 256 x 100 x 2 float32 (chip_smoke.py's
              kernel_split state, column ssh): ms per call by CUDA events
              (three reads of 20 calls) and each pass's device ms per call
              from torch.profiler over 20 whole calls, with the launches
              the trace recorded
  split_post  splitpost on splitpre's output and the barotropic
              subcycles' (M = 10) at the same shape: ms per call by CUDA
              events (three reads of 20 calls), its registers, spill and
              blocks per SM where the checkout reads them
  fct_b       FCT's stage B at icos48 x 100 x 2 float32 (chip_smoke.py's
              kernel_patch_fct inputs: center thickness flux, a 0/1 cap,
              u = 0.05 x noise, stage A's refreshed output): ms per call by
              CUDA events (three reads of 20 calls), each launch's device
              ms per call (torch.profiler over 20 whole calls, by kernel
              name), and each launch's registers, spill and blocks per SM
              where the checkout reads them
  pp81        the PP81 coefficient kernels on chip_smoke.py's full-width
              inputs, float32: the plane's (csrc/vmix.cu) at 256 x 256 x
              100 x 2 on the state one science FB step leaves (upwind
              fluxes, wind, drag), the sphere's (csrc/patch_vmix.cu) at
              icos48 x 100 x 2 on the frames the science patch step writes:
              ms per call by CUDA events (three reads of 20 calls), with
              the kernels' registers, spill and blocks per SM where the
              checkout reads them, and nvcc's report of them
  bt          the barotropic subcycles, M = 10, dt_bt = 12 s, float32, on
              random inputs from a seed: the plane's (csrc/barotropic.cu)
              at 256 x 256 (ub 0.01 x noise, ssh noise, g_slow 1e-6 x
              noise, het 1000 + noise), the sphere's (csrc/bt_gather.cu) at
              icos48 (the same, masked by edge_mask; het 4000 + noise):
              ms per call by CUDA events (three reads of 20 calls) through
              the wrappers with the outputs and scratch made once, and, for
              a checkout whose sphere wrapper converts the mesh every call
              (no bt_gather.mesh_view), also its C entry called on arrays
              converted once (the parent kernel with the cache alone); the
              kernels' registers, spill, blocks per SM and grid where the
              checkout reads them. With PASS_TIMES_SAVE=DIR both
              kernels' outputs on these inputs at M = 1, 7, 10, 30 (bt_drag
              1e-4 at M = 7), float32 and float64, go to DIR/bt_bits.pt;
              with PASS_TIMES_COMPARE=DIR they are held bit for bit against
              that file (another checkout's)
  stencil     the structured stencil kernel (csrc/stencil.cu) at 256 x
              256 x 100 float32 on random inputs from a seed: each of the
              ten tables of the composed FB step at each leading count it
              takes there (port_bounds.FB_STEP_GATHERS) and cdiff on one
              plane (the column ssh gradient), ms a call by CUDA events
              (three reads of 20 calls) beside the call's byte bound, with
              the kernel's registers, spill and blocks per SM where the
              checkout reads them (stencil_kernel.attrs); and each pass's
              device ms in one
              composed FB step (column ssh, chip_smoke.py's composed_path
              state; torch.profiler, the kernel's records in launch order
              matched to the passes the step made, three steps, a step
              whose records do not match left out) beside its bound
              (port_bounds.composed_planar_passes). With
              PASS_TIMES_SAVE=DIR the SHA-256 of the float32 output of
              every table (22, at leading counts 1 and 2, inputs from a
              seed of their own) goes to DIR/stencil_bits.json; with
              PASS_TIMES_COMPARE=DIR they are held against that file
              (another checkout's), bit for bit
  sphere      host ms per step (three 10-step segments through run_steps,
              each ending in torch.cuda.synchronize()) of icos48 x 100 x 2
              float32: the flagship configuration and the science one
              (upwind fluxes, wind, drag 3e-3, PP81), as chip_smoke.py's
              sphere_path and sphere_science_path drive them

Needs a CUDA device; imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import time


def emit(obj):
    print(json.dumps(obj), flush=True)


PARTS = ("split", "fct_b", "pp81", "bt", "stencil", "sphere")


def main(argv):
    parts = set(argv) or set(PARTS)
    if not parts <= set(PARTS):
        print(f"parts: {', '.join(PARTS)}", file=sys.stderr)
        return 2
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("pass_times.py needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ".")
    from omega_tpu_torch.core import (ModelConfig, ModelState,
                                      TendencyConfig, VertMixConfig)
    from omega_tpu_torch.mesh import (patch_icos_mesh, planar_hex_mesh,
                                      spherical_icos_mesh)
    from omega_tpu_torch.ops import _build, megastep
    from omega_tpu_torch.stepping import forward_backward_step, run_steps
    dev, rng = "cuda", np.random.default_rng(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    emit({"device": torch.cuda.get_device_name(0),
          "nvidia_smi": smi.stdout.strip()})

    _build.load()
    lines = _build.BUILD_INFO["ptxas"].splitlines()
    emit({"ptxas": [[ln.split("'")[1]] + [x.strip() for x in
                                          lines[i + 1:i + 5]]
                    for i, ln in enumerate(lines)
                    if "Compiling entry function" in ln
                    and (("split_" in ln and "patch" not in ln)
                         or "pp81" in ln)]})

    def cuda_ms(fn, reps=20):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    def pass_ms(fn, kernels, reps=20):
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us, n = dict.fromkeys(kernels, 0.0), dict.fromkeys(kernels, 0)
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                for lab, sub in kernels.items():
                    if sub in e.key:
                        us[lab] += e.device_time_total
                        n[lab] += e.count
        return {lab: {"ms": us[lab] / n[lab] / 1e3 if n[lab] else None,
                      "launches_recorded": n[lab]} for lab in kernels}

    K, L = 100, 2
    put = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    tend = dict(visc_del2=1.0e3, visc_del4=1.0e9)
    pp81 = VertMixConfig(enabled=True, scheme="pp81", temp_index=0,
                         salt_index=1)
    science = ModelConfig(
        nvertlayers=K, ntracers=L, flux_thickness_type="upwind",
        flux_tracer_type="upwind", vert_mix=pp81,
        tendencies=TendencyConfig(wind_forcing=True, bottom_drag=True,
                                  bottom_drag_coeff=3.0e-3, **tend))
    pp81_rec = {}
    if "pp81" in parts:
        from omega_tpu_torch.ops import vmix_kernel
        mesh_np = planar_hex_mesh(256, 256, dc=5000.0, f0=1e-4,
                                  bottom_depth=1000.0)
        mesh = mesh_np.to(dev, torch.float32)
        kx = 2 * np.pi / mesh_np.x_period
        ky = 2 * np.pi / mesh_np.y_period
        ssh = np.sin(kx * mesh_np.x_cell) * np.sin(ky * mesh_np.y_cell)
        st = ModelState(
            put((1000.0 + ssh[:, None]) / K * np.ones((1, K))),
            put(0.05 * rng.standard_normal((mesh_np.nedges, K))),
            put(np.stack([10.0 + 2.0 * np.arange(K)[::-1] / K
                          + 0.1 * rng.standard_normal((mesh_np.ncells, K)),
                          35.0 + 0.1 * rng.standard_normal(
                              (mesh_np.ncells, K))])))
        cfg_h = ModelConfig(
            nvertlayers=K, ntracers=L, flux_thickness_type="upwind",
            flux_tracer_type="upwind",
            tendencies=TendencyConfig(wind_forcing=True, bottom_drag=True,
                                      bottom_drag_coeff=3.0e-3, **tend))
        wind_p = (put(0.1 * np.sin(ky * mesh_np.y_cell)),
                  put(0.05 * np.ones(mesh_np.ncells)))
        sv = megastep.fb_megastep_stacked(
            mesh, cfg_h, megastep.stack_state(mesh, st), 30.0,
            wind=megastep.stack_wind(mesh, cfg_h, wind_p, torch.float32))
        fn = lambda: vmix_kernel.pp81_coeffs(mesh, science, sv)
        rec = {"ms": [cuda_ms(fn) for _ in range(3)]}
        if hasattr(vmix_kernel, "coeff_attrs"):
            rec["attrs"] = vmix_kernel.coeff_attrs(torch.float32)
        pp81_rec["plane"] = rec
        del sv, st, mesh
    if "split" in parts:
        mesh_np = planar_hex_mesh(256, 256, dc=5000.0, f0=1e-4,
                                  bottom_depth=1000.0)
        mesh = mesh_np.to(dev, torch.float32)
        cfg = ModelConfig(nvertlayers=K, ntracers=L, ssh_formulation="column",
                          tendencies=TendencyConfig(visc_del2=1.0e3,
                                                    visc_del4=1.0e9))
        kx = 2 * np.pi / mesh_np.x_period
        st = ModelState(
            put((1000.0 + np.sin(kx * mesh_np.x_cell))[:, None] / K
                * np.ones((1, K))),
            put(0.01 * rng.standard_normal((mesh_np.nedges, K))),
            put(10.0 + rng.standard_normal((L, mesh_np.ncells, K))))
        s0 = megastep.stack_state(mesh, st)
        du, planes = megastep.split_work(s0)
        fn = lambda: megastep.split_pre(mesh, cfg, s0, du, planes)
        emit({"split_pre": {
            "ms": [cuda_ms(fn) for _ in range(3)],
            "passes": pass_ms(fn, {p: f"split_{p}_kernel"
                                   for p in ("columns", "chain", "slow")})}})
        from omega_tpu_torch.ops import barotropic_kernel as btk
        btk.bt_planes(mesh, planes[:megastep.P_DUBAR], gravity=cfg.gravity,
                      dt_bt=12.0, n_subcycles=10,
                      out=planes[megastep.P_UBF:megastep.P_UAVG + 3],
                      work=planes[megastep.P_WORK:])
        out = torch.empty_like(s0)
        fn = lambda: megastep.split_post(mesh, cfg, s0, du, planes, 120.0, out)
        rec = {"ms": [cuda_ms(fn) for _ in range(3)]}
        if hasattr(megastep, "split_post_attrs"):
            rec["attrs"] = megastep.split_post_attrs(torch.float32)
        emit({"split_post": rec})
        del s0, du, planes, st, out

    mnp = patch_icos_mesh(spherical_icos_mesh(48), 48)
    m = mnp.to(dev, torch.float32)
    lat, lon = np.asarray(mnp.lat_cell), np.asarray(mnp.lon_cell)
    depth = float(np.asarray(mnp.bottom_depth)[0])
    T = 10.0 + 2.0 * np.arange(K)[::-1] / K \
        + 0.1 * rng.standard_normal((mnp.ncells, K))
    S = 35.0 + 0.1 * rng.standard_normal((mnp.ncells, K))
    sph = ModelState(
        put((depth + np.sin(2 * lat) * np.cos(lon))[:, None] / K
            * np.ones((1, K))),
        put(0.01 * rng.standard_normal((mnp.nedges, K))
            * np.asarray(mnp.edge_mask)[:, None]),
        put(np.stack([T, S])))
    wind = (put(0.1 * np.cos(lat)), put(0.05 * np.sin(lat)))

    if "pp81" in parts:
        from omega_tpu_torch.ops import patch_megastep as pm
        p48 = pm.prep(m, torch.float32, dev)
        fr, _ = pm.stack_frames(m, science, sph)
        out = torch.empty_like(fr)
        pm.chain(p48, science, fr, 30.0, out, pm.new_work(fr),
                 pm.make_wind(m, science, wind, torch.float32))
        coef = pm.new_coef(out, science)
        fn = lambda: pm.vmix_coeffs(p48, science, out, coef)
        rec = {"ms": [cuda_ms(fn) for _ in range(3)]}
        if hasattr(pm, "coeff_attrs"):
            rec["attrs"] = pm.coeff_attrs(science, out)
        pp81_rec["sphere"] = rec
        emit({"pp81": pp81_rec})
        del fr, out, coef, p48

    # FCT's stage B on stage A's refreshed output
    if "fct_b" in parts:
        from omega_tpu_torch.ops import patch_megastep as pm
        cfg_f = ModelConfig(nvertlayers=K, ntracers=L, flux_tracer_type="fct",
                            tendencies=TendencyConfig(visc_del2=1.0e3,
                                                      visc_del4=1.0e9))
        cap = (np.cos(lat) * np.cos(lon) > 0.7)[:, None] * np.ones((1, K))
        st_f = ModelState(
            sph.h, put(0.05 * rng.standard_normal((mnp.nedges, K))
                       * np.asarray(mnp.edge_mask)[:, None]),
            put(np.stack([cap, 10.0 + 0.0 * cap])))
        pf = pm.prep(m, torch.float32, dev, fct=True)
        fr, fix = pm.stack_frames(m, cfg_f, st_f)
        mid_fix, _ = pm.fct_sub_a(pf, cfg_f, fr, fix, 0.0, 30.0)
        mid = pm.fct_refresh_mid(pf, pm.fct_a(pf, cfg_f, fr, 30.0), mid_fix)
        out, work = torch.empty_like(fr), pm.new_work(fr)
        fn = lambda: pm.fct_b(pf, cfg_f, mid, fr, 30.0, out, work)
        fn()
        torch.cuda.synchronize()
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        launches = {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA \
                    and "patch::fct::" in e.key:
                name = e.key.split("fct::")[1].split("<")[0]
                launches[name] = {"ms": e.device_time_total / 20 / 1e3,
                                  "launches_recorded": e.count}
        rec = {"ms": [cuda_ms(fn) for _ in range(3)], "launches": launches}
        if hasattr(pm, "fct_b_attrs"):
            rec["attrs"] = pm.fct_b_attrs(cfg_f, torch.float32)
        emit({"fct_b": rec})
        del fr, mid, out, work, st_f

    if "bt" in parts:
        from omega_tpu_torch.ops import barotropic_kernel as btk
        from omega_tpu_torch.ops import bt_gather
        save = os.environ.get("PASS_TIMES_SAVE")
        rb = np.random.default_rng(17)
        kw = dict(gravity=9.80616, dt_bt=12.0, n_subcycles=10)
        pm_np = planar_hex_mesh(256, 256, dc=5000.0, f0=1e-4,
                                bottom_depth=1000.0)
        pmesh = pm_np.to(dev, torch.float32)
        stack = put(np.concatenate([
            0.01 * rb.standard_normal((3, 256, 256)),
            rb.standard_normal((1, 256, 256)),
            1e-6 * rb.standard_normal((3, 256, 256)),
            1000.0 + rb.standard_normal((3, 256, 256))])).contiguous()
        out = torch.empty((7, 256, 256), dtype=torch.float32, device=dev)
        work = torch.empty((4, 256, 256), dtype=torch.float32, device=dev)
        fn = lambda: btk.bt_planes(pmesh, stack, out=out, work=work, **kw)
        rec = {"ms": [cuda_ms(fn) for _ in range(3)]}
        if hasattr(btk, "attrs"):
            rec["attrs"] = btk.attrs(torch.float32, pmesh)
        emit({"bt_plane": rec})
        E, C = mnp.nedges, mnp.ncells
        em = put(np.asarray(mnp.edge_mask)[:, None])
        ins = (put(0.01 * rb.standard_normal((E, 1))) * em,
               put(rb.standard_normal((C, 1))),
               put(1e-6 * rb.standard_normal((E, 1))) * em,
               put(4000.0 + rb.standard_normal((E, 1))))
        rec = {}
        if hasattr(bt_gather, "mesh_view"):
            o, w = bt_gather.new_buffers(ins[0], ins[1])
            fn = lambda: bt_gather.bt_subcycles(m, *ins, **kw, out=o,
                                                work=w)
            rec["attrs"] = bt_gather.attrs(torch.float32, m)
        else:
            fn = lambda: bt_gather.bt_subcycles(m, *ins, **kw)
            ma = bt_gather._mesh_arrays(m, torch.float32, m.edge_mask.device)
            o = tuple(torch.empty_like(a) for a in (ins[0], ins[1], ins[0]))
            ub_work = torch.empty_like(ins[0])
            lib = _build.load()
            consts = np.array([12.0, -9.80616, 0.0], np.float64)
            ints = np.array([E, C, ma["eoe"].shape[1], ma["eoc"].shape[1],
                             10, 256], np.int32)
            stream = torch.cuda.current_stream().cuda_stream
            cached = lambda: lib.omega_bt_gather_f32(
                *(a.data_ptr() for a in ins), o[0].data_ptr(),
                ub_work.data_ptr(), o[1].data_ptr(), o[2].data_ptr(),
                *(ma[k].data_ptr() for k in ("coe", "dc", "eoe", "woe",
                                             "eoc", "wdiv", "f_e", "mask")),
                consts.ctypes.data, ints.ctypes.data, stream)
            rec["cached_ms"] = [cuda_ms(cached) for _ in range(3)]
        rec["ms"] = [cuda_ms(fn) for _ in range(3)]
        emit({"bt_sphere": rec})
        compare = os.environ.get("PASS_TIMES_COMPARE")
        if save or compare:
            bits = {}
            for dt in (torch.float32, torch.float64):
                pm_, m_ = pm_np.to(dev, dt), mnp.to(dev, dt)
                st_, in_ = stack.to(dt), tuple(a.to(dt) for a in ins)
                for M, r in ((1, 0.0), (7, 1e-4), (10, 0.0), (30, 0.0)):
                    k = dict(gravity=9.80616, dt_bt=120.0 / M, n_subcycles=M,
                             bt_drag=r)
                    bits[f"plane {dt} M={M} r={r}"] = [
                        btk.bt_planes(pm_, st_, **k).cpu()]
                    bits[f"sphere {dt} M={M} r={r}"] = [
                        a.cpu() for a in bt_gather.bt_subcycles(m_, *in_,
                                                                **k)]
            if save:
                torch.save(bits, os.path.join(save, "bt_bits.pt"))
            if compare:
                ref = torch.load(os.path.join(compare, "bt_bits.pt"))
                emit({"bt_bits_equal": {
                    k: all(torch.equal(a, b) for a, b in zip(v, ref[k]))
                    for k, v in bits.items()}})
        del stack, out, work, ins

    if "stencil" in parts:
        stencil_part(np, torch, dev, cuda_ms)

    if "sphere" in parts:
        cfgs = {
            "flagship": (ModelConfig(nvertlayers=K, ntracers=L,
                                     tendencies=TendencyConfig(**tend)), None),
            "science": (science, wind)}
        host = {}
        for name, (c, w) in cfgs.items():
            run_steps(m, c, sph, 0.0, 30.0, 1, wind_stress=w)     # untimed
            s, segs = sph, []
            for i in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                s = run_steps(m, c, s, i * 300.0, 30.0, 10,
                              stepper=forward_backward_step, wind_stress=w)
                torch.cuda.synchronize()
                segs.append((time.perf_counter() - t0) / 10 * 1e3)
            host[name] = segs
        emit({"sphere": {"host_ms_per_step": host}})
    return 0


def stencil_part(np, torch, dev, cuda_ms, N=256, K=100):
    import hashlib
    import importlib.util
    import re

    # this script's port_bounds, also when run from another checkout
    spec = importlib.util.spec_from_file_location(
        "port_bounds", os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "port_bounds.py"))
    port_bounds = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(port_bounds)
    from omega_tpu_torch.core import ModelConfig, ModelState, TendencyConfig
    from omega_tpu_torch.mesh import planar_hex_mesh
    from omega_tpu_torch.ops import stencil_kernel, structured
    from omega_tpu_torch.stepping import forward_backward_step, run_steps
    from torch.profiler import ProfilerActivity, profile

    L = 2
    rs = np.random.default_rng(23)
    mesh_np = planar_hex_mesh(N, N, dc=5000.0, f0=1e-4, bottom_depth=1000.0)
    mesh = mesh_np.to(dev, torch.float32)
    tabs = {k[3]: v for k, v in structured._TABLE_CACHE.items()
            if k[:3] == (N, N, mesh.structured_dc)}
    calls = sorted(set((t, lead, k if k == 1 else K) for t, lead, k
                       in port_bounds.COMPOSED_FB_PASSES))
    rec, bits = {}, {}
    for t, lead, k in calls:
        tab, dst, src = tabs[t]
        ps = structured._NPER[src]
        f = torch.as_tensor(rs.standard_normal((lead, ps * N * N, k)),
                            dtype=torch.float32, device=dev)
        fn = lambda: structured.apply_stencil(mesh, (tab, dst, src), f)
        b = port_bounds.bound(
            sum(port_bounds.HEX_CLASSES[t]) * lead * N * N * k * 4, 0)
        r = {"ms": [cuda_ms(fn) for _ in range(3)],
             "bound_ms": b["bound_ms"]}
        if hasattr(stencil_kernel, "attrs"):
            r["attrs"] = stencil_kernel.attrs(torch.float32,
                                              k % 4 == 0)
        rec[f"{t} x{lead} K={k}"] = r
        del f
    print(json.dumps({"stencil": rec}), flush=True)
    # every table's output at leading counts 1 and 2, on inputs of its own
    # seed (the same in every checkout)
    for i, (t, (tab, dst, src)) in enumerate(sorted(tabs.items())):
        for lead in (1, 2):
            f = torch.as_tensor(np.random.default_rng(100 * i + lead)
                                .standard_normal((lead, structured._NPER[src]
                                                  * N * N, K)),
                                dtype=torch.float32, device=dev)
            bits[f"{t} x{lead}"] = hashlib.sha256(structured.apply_stencil(
                mesh, (tab, dst, src), f).cpu().numpy().tobytes()).hexdigest()
            del f

    # each pass of one composed FB step with column ssh
    cfg = ModelConfig(nvertlayers=K, ntracers=L, ssh_formulation="column",
                      tendencies=TendencyConfig(visc_del2=1.0e3,
                                                visc_del4=1.0e9))
    kx = 2 * np.pi / mesh_np.x_period
    ky = 2 * np.pi / mesh_np.y_period
    ssh = np.sin(kx * mesh_np.x_cell) * np.sin(ky * mesh_np.y_cell)
    put = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    st = ModelState(put((1000.0 + ssh[:, None]) / K * np.ones((1, K))),
                    put(np.zeros((mesh_np.nedges, K))),
                    put(10.0 + np.zeros((L, mesh_np.ncells, K))))
    names = {id(v[0]): k for k, v in tabs.items()}
    made, real = [], stencil_kernel.apply

    def spy(tab, ps, pd, nx, ny, field):
        made.append((names[id(tab)], int(np.prod(field.shape[:-2])),
                     field.shape[-1]))
        return real(tab, ps, pd, nx, ny, field)
    step = lambda: run_steps(mesh, cfg, st, 0.0, 30.0, 1,
                             stepper=forward_backward_step)
    step()
    torch.cuda.synchronize()
    kern = re.compile(r"stencil_(tiled_|direct_)?kernel")
    reads, dropped = [], 0
    stencil_kernel.apply = spy
    try:
        for _ in range(3):
            made.clear()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                step()
                torch.cuda.synchronize()
            evs = sorted((e for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA
                          and kern.search(e.name)),
                         key=lambda e: e.time_range.start)
            if len(evs) != len(made):
                dropped += 1
                continue
            reads.append([(m, e.time_range.elapsed_us() / 1e3)
                          for m, e in zip(made, evs)])
    finally:
        stencil_kernel.apply = real
    bounds = port_bounds.composed_planar_passes(N, N)
    out = {"steps_read": len(reads), "steps_left_out": dropped}
    if reads:
        order = [m for m, _ in reads[0]]
        want = [(p["table"], p["lead"], p["K"]) for p in bounds["passes"]]
        out["order_as_port_bounds"] = order == want
        out["passes"] = [
            {"table": m[0], "lead": m[1], "K": m[2],
             "ms": sorted(r[i][1] for r in reads)[len(reads) // 2],
             "bound_ms": bounds["passes"][i]["bound_ms"]
             if order == want else None}
            for i, m in enumerate(order)]
        out["sum_ms"] = sum(p["ms"] for p in out["passes"])
        out["sum_bound_ms"] = bounds["sum"]["bound_ms"]
    print(json.dumps({"stencil_passes": out}), flush=True)

    save = os.environ.get("PASS_TIMES_SAVE")
    compare = os.environ.get("PASS_TIMES_COMPARE")
    if save:
        with open(os.path.join(save, "stencil_bits.json"), "w") as fh:
            json.dump(bits, fh)
    if compare:
        with open(os.path.join(compare, "stencil_bits.json")) as fh:
            ref = json.load(fh)
        print(json.dumps({"stencil_bits_equal": {
            k: v == ref.get(k) for k, v in bits.items()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
