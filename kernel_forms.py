#!/usr/bin/env python3
"""Forms of the two PP81 coefficient kernels, of the two barotropic
subcycle kernels and of the structured stencil kernel, timed on one NVIDIA
GPU.

    python3 kernel_forms.py kernel_forms_pp81.json   # from a checkout's root
    python3 kernel_forms.py kernel_forms_bt.json
    python3 kernel_forms.py kernel_forms_stencil.json

Each form in the JSON list is one of the checkout's kernel sources
(`file`: vmix.cu for the plane's coefficient kernel, patch_vmix.cu for the
sphere's, barotropic.cu and bt_gather.cu for the subcycles), or the text of
another file of the repo in its place (`source`), with text substitutions
(`subs`: [old, new] pairs, each of which must occur), compiled with the
package's nvcc flags into a library of its own and launched through its C
entry point on chip_smoke.py's full-width shapes, float32. The coefficient
kernels: the plane at 256 x 256 x 100 x 2 on the state one science FB step
leaves, the sphere at icos48 x 100 x 2 on the frames the science patch
step writes; a plane form runs at each of its `groups` (the record's
groups of interfaces), a sphere form at each of its `threads` per block.
The subcycles: random inputs from a seed (ub 0.01 x noise, ssh noise,
g_slow 1e-6 x noise, het 1000 + noise on the plane at 256 x 256, 4000 +
noise on the sphere at icos48, masked by edge_mask), dt_bt = 12 s, at each
of the form's `M` (default 10); a plane form at each of its `grid` (0: the
launcher's choice), a sphere form at each of its `threads` and `groups`
(cell groups; 0 for either: the package's choice). The stencil kernel
(stencil.cu): tang with two leading indices, cmean and div with one, at
256 x 256 x 100 on random inputs from a seed (the two tiled designs tried
against it: kernel_forms_stencil_chunked.cu, kernel_forms_stencil_segment.cu);
a form whose record ends in a grid size (the K-chunked design) runs at each
of its `blocks`. Prints one JSON line per form and
setting: ms per call by CUDA events (three reads of 20 calls), whether its
output is the checkout's own kernel's bit for bit (a form that skips work
is not), and nvcc's registers and spill for it; first the card's name and
power limit and the checkout's own kernels' times. Imports nothing of JAX.
"""

# the kernels whose nvcc report a form prints, by file
PTXAS = {"vmix.cu": ("pp81", "If"), "patch_vmix.cu": ("pp81", "If"),
         "barotropic.cu": ("bt_kernel", "If"),
         "bt_gather.cu": ("bt_gather_kernel", "If"),
         "stencil.cu": ("stencil_", "If")}

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path


def emit(obj):
    print(json.dumps(obj), flush=True)


def main(argv):
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_forms.py needs a CUDA device", file=sys.stderr)
        return 1
    forms = json.loads(Path(argv[0]).read_text())
    sys.path.insert(0, ".")
    from omega_tpu_torch.core import (ModelConfig, ModelState,
                                      TendencyConfig, VertMixConfig)
    from omega_tpu_torch.mesh import (patch_icos_mesh, planar_hex_mesh,
                                      spherical_icos_mesh)
    from omega_tpu_torch.ops import _build, megastep, vmix_kernel
    from omega_tpu_torch.ops import patch_megastep as pm
    dev, rng = "cuda", np.random.default_rng(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    emit({"device": torch.cuda.get_device_name(0),
          "nvidia_smi": smi.stdout.strip()})
    _build.load()

    # every form's library, built side by side
    tmp = Path(tempfile.mkdtemp())
    procs = {}
    for f in forms:
        d = tmp / f["name"]
        d.mkdir()
        for src in _build.CSRC.glob("*.cu*"):
            (d / src.name).write_text(src.read_text())
        text = (Path(f["source"]) if "source" in f
                else _build.CSRC / f["file"]).read_text()
        for old, new in f.get("subs", []):
            if old not in text:
                raise ValueError(f"form {f['name']}: {old!r} not in "
                                 f"{f['file']}")
            text = text.replace(old, new)
        (d / f["file"]).write_text(text)
        procs[f["name"]] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
             str(d / "lib.so"), str(d / f["file"])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        lines = out.splitlines()
        built[name] = proc.returncode == 0
        if not built[name]:
            emit({"form": name, "build_failed": out[-3000:]})
        # nvcc's report of the form's float32 kernels in this library
        key, typ = PTXAS[next(f["file"] for f in forms if f["name"] == name)]
        built[name, "ptxas"] = [
            [lines[i].split("'")[1]] + [x.strip() for x in lines[i + 2:i + 4]]
            for i, ln in enumerate(lines)
            if "Compiling entry function" in ln and key in ln
            and typ in ln]

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

    def run(name, call, outputs, ref, setting):
        for o in outputs:
            o.fill_(0.0)
        code = call()
        ms = [cuda_ms(call) for _ in range(3)]
        torch.cuda.synchronize()
        same = all(torch.equal(o.nan_to_num(7.0), r.nan_to_num(7.0))
                   for o, r in zip(outputs, ref))
        emit({"form": name, **setting, "code": code, "ms": ms,
              "same": same, "ptxas": built[name, "ptxas"]})

    put = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    files = {f["file"] for f in forms}

    # ---- the plane's subcycles
    if "barotropic.cu" in files:
        from omega_tpu_torch.ops import barotropic_kernel as btk
        rb = np.random.default_rng(17)
        mesh = planar_hex_mesh(256, 256, dc=5000.0, f0=1e-4,
                               bottom_depth=1000.0).to(dev, torch.float32)
        stack = put(np.concatenate([
            0.01 * rb.standard_normal((3, 256, 256)),
            rb.standard_normal((1, 256, 256)),
            1e-6 * rb.standard_normal((3, 256, 256)),
            1000.0 + rb.standard_normal((3, 256, 256))])).contiguous()
        out = torch.empty((7, 256, 256), dtype=torch.float32, device=dev)
        work = torch.empty((4, 256, 256), dtype=torch.float32, device=dev)
        refs = {}

        def ref_plane(M):
            if M not in refs:
                refs[M] = btk.bt_planes(mesh, stack, gravity=9.80616,
                                        dt_bt=12.0, n_subcycles=M).clone()
            return refs[M]
        emit({"bt_plane": {"ms": [cuda_ms(lambda: btk.bt_planes(
            mesh, stack, gravity=9.80616, dt_bt=12.0, n_subcycles=10,
            out=out, work=work)) for _ in range(3)],
            "attrs": btk.attrs(torch.float32, mesh)}})
        rec = btk._rec(mesh, torch.float32)
        c = btk._consts(mesh, 9.80616, 12.0, 0.0)
        for f in forms:
            if f["file"] != "barotropic.cu" or not built[f["name"]]:
                continue
            fn = ctypes.CDLL(str(tmp / f["name"] / "lib.so")) \
                .omega_barotropic_f32
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_double] * 4 \
                + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            for M in f.get("M", [10]):
                for grid in f.get("grid", [0]):
                    run(f["name"], lambda: fn(
                        stack.data_ptr(), out.data_ptr(), work.data_ptr(),
                        rec.ctypes.data, c["dt_bt"], c["ggrad"], c["f_e"],
                        c["r"], M, grid, stream), (out,), (ref_plane(M),),
                        {"M": M, "grid": grid})
        del stack, out, work, refs

    # ---- the sphere's subcycles
    if "bt_gather.cu" in files:
        from omega_tpu_torch.ops import bt_gather
        rb = np.random.default_rng(17)
        mnp = patch_icos_mesh(spherical_icos_mesh(48), 48)
        m = mnp.to(dev, torch.float32)
        E, C = mnp.nedges, mnp.ncells
        em = put(np.asarray(mnp.edge_mask)[:, None])
        ins = (put(0.01 * rb.standard_normal((E, 1))) * em,
               put(rb.standard_normal((C, 1))),
               put(1e-6 * rb.standard_normal((E, 1))) * em,
               put(4000.0 + rb.standard_normal((E, 1))))
        o, w = bt_gather.new_buffers(ins[0], ins[1])
        kw = dict(gravity=9.80616, dt_bt=12.0)
        refs = {}

        def ref_sphere(M):
            if M not in refs:
                refs[M] = tuple(a.clone() for a in bt_gather.bt_subcycles(
                    m, *ins, n_subcycles=M, **kw))
            return refs[M]
        ng = bt_gather.n_groups(m, dev)
        emit({"bt_sphere": {"ms": [cuda_ms(lambda: bt_gather.bt_subcycles(
            m, *ins, n_subcycles=10, out=o, work=w, **kw))
            for _ in range(3)], "groups": ng,
            "attrs": bt_gather.attrs(torch.float32, m)}})
        for f in forms:
            if f["file"] != "bt_gather.cu" or not built[f["name"]]:
                continue
            fn = ctypes.CDLL(str(tmp / f["name"] / "lib.so")).omega_bt_gather_f32
            fn.argtypes = [ctypes.c_void_p] * 4
            fn.restype = ctypes.c_int
            for M in f.get("M", [10]):
                for th in f.get("threads", [0]):
                    for g in f.get("groups", [0]):
                        view = bt_gather.mesh_view(m, torch.float32, dev,
                                                   g or ng)
                        a = bt_gather.call_args(view, ins, o, w,
                                                n_subcycles=M,
                                                threads=th or None, **kw)
                        run(f["name"], lambda: fn(
                            a[0].ctypes.data, a[1].ctypes.data,
                            a[2].ctypes.data, stream), o, ref_sphere(M),
                            {"M": M, "threads": th or bt_gather.block_threads(
                                view["max_list"]), "groups": g or ng,
                             "max_list": view["max_list"]})
        del ins, o, w, refs
    # ---- the structured stencil kernel
    if "stencil.cu" in files:
        from omega_tpu_torch.ops import stencil_kernel, structured
        rs = np.random.default_rng(23)
        N = 256
        mesh = planar_hex_mesh(N, N, dc=5000.0, f0=1e-4,
                               bottom_depth=1000.0).to(dev, torch.float32)
        cases, own = {}, {}
        for t, lead in (("tang", 2), ("cmean", 1), ("div", 1)):
            tab, dst, src = structured._TABLE_CACHE[
                (N, N, mesh.structured_dc, t)]
            ps, pd = structured._NPER[src], structured._NPER[dst]
            fld = put(rs.standard_normal((lead, ps * N * N, 100)))
            call = lambda: structured.apply_stencil(mesh, (tab, dst, src),
                                                    fld)
            own[t] = [cuda_ms(call) for _ in range(3)]
            cases[t] = (tab, ps, pd, lead, fld, torch.empty(
                (lead, pd * N * N, 100), dtype=torch.float32, device=dev),
                call().clone())
        emit({"stencil": {"ms": own}})
        for f in forms:
            if f["file"] != "stencil.cu" or not built[f["name"]]:
                continue
            fn = ctypes.CDLL(str(tmp / f["name"] / "lib.so")).omega_stencil_f32
            fn.argtypes = [ctypes.c_void_p] * 4
            fn.restype = ctypes.c_int
            for blocks in f.get("blocks", [None]):
                for t, (tab, ps, pd, lead, fld, out, ref) in cases.items():
                    rec = stencil_kernel.launch_record(
                        tab, ps, pd, N, N, lead, 100, np.float32)
                    if blocks is not None:
                        # the record with the grid size appended
                        big = np.zeros((), np.dtype(
                            rec.dtype.descr + [("blocks", "i4")], align=True))
                        for name in rec.dtype.names:
                            big[name] = rec[name]
                        big["blocks"] = blocks
                        rec = big
                    run(f["name"], lambda: fn(fld.data_ptr(), out.data_ptr(),
                                              rec.ctypes.data, stream),
                        (out,), (ref,), {"table": t, "lead": lead,
                                         "blocks": blocks})
        del cases
    if not files & {"vmix.cu", "patch_vmix.cu"}:
        return 0

    K, L = 100, 2
    tend = dict(visc_del2=1.0e3, visc_del4=1.0e9)
    science = ModelConfig(
        nvertlayers=K, ntracers=L, flux_thickness_type="upwind",
        flux_tracer_type="upwind",
        vert_mix=VertMixConfig(enabled=True, scheme="pp81", temp_index=0,
                               salt_index=1),
        tendencies=TendencyConfig(wind_forcing=True, bottom_drag=True,
                                  bottom_drag_coeff=3.0e-3, **tend))

    # ---- the plane: the state one science FB step leaves
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
    ref = vmix_kernel.pp81_coeffs(mesh, science, sv)
    emit({"plane": {"ms": [cuda_ms(lambda: vmix_kernel.pp81_coeffs(
        mesh, science, sv)) for _ in range(3)],
        "plan": vmix_kernel.plan_coeffs(256, 256, K)}})
    rec = vmix_kernel.pack_params(mesh, science, 0.0, np.float32, L, K)
    kap, nu = torch.empty_like(ref[0]), torch.empty_like(ref[1])
    for f in forms:
        if f["file"] != "vmix.cu" or not built[f["name"]]:
            continue
        fn = ctypes.CDLL(str(tmp / f["name"] / "lib.so")).omega_pp81_coeffs_f32
        fn.argtypes = [ctypes.c_void_p] * 5
        fn.restype = ctypes.c_int
        for g in f.get("groups", [rec["groups"]]):
            r = rec.copy()
            r["groups"] = g
            run(f["name"], lambda: fn(sv.data_ptr(), kap.data_ptr(),
                                      nu.data_ptr(), r.ctypes.data, stream),
                (kap, nu), ref, {"groups": g})
    del sv, st, kap, nu, ref

    # ---- the sphere: the frames the science patch step writes
    mnp = patch_icos_mesh(spherical_icos_mesh(48), 48)
    m = mnp.to(dev, torch.float32)
    lat, lon = np.asarray(mnp.lat_cell), np.asarray(mnp.lon_cell)
    depth = float(np.asarray(mnp.bottom_depth)[0])
    sph = ModelState(
        put((depth + np.sin(2 * lat) * np.cos(lon))[:, None] / K
            * np.ones((1, K))),
        put(0.01 * rng.standard_normal((mnp.nedges, K))
            * np.asarray(mnp.edge_mask)[:, None]),
        put(np.stack([10.0 + 2.0 * np.arange(K)[::-1] / K
                      + 0.1 * rng.standard_normal((mnp.ncells, K)),
                      35.0 + 0.1 * rng.standard_normal((mnp.ncells, K))])))
    wind = (put(0.1 * np.cos(lat)), put(0.05 * np.sin(lat)))
    p48 = pm.prep(m, torch.float32, dev)
    fr, _ = pm.stack_frames(m, science, sph)
    out = torch.empty_like(fr)
    pm.chain(p48, science, fr, 30.0, out, pm.new_work(fr),
             pm.make_wind(m, science, wind, torch.float32))
    ref = pm.vmix_coeffs(p48, science, out)[:-1].clone()
    coef = pm.new_coef(out, science)
    emit({"sphere": {"ms": [cuda_ms(lambda: pm.vmix_coeffs(
        p48, science, out, coef)) for _ in range(3)]}})
    consts, ints0 = pm._vmix_args(p48, science, out, 0.0)
    for f in forms:
        if f["file"] != "patch_vmix.cu" or not built[f["name"]]:
            continue
        fn = ctypes.CDLL(str(tmp / f["name"] / "lib.so")).omega_patch_pp81_f32
        fn.argtypes = [ctypes.c_void_p] * 7
        fn.restype = ctypes.c_int
        for th in f.get("threads", [int(ints0[7])]):
            ints = ints0.copy()
            ints[7] = th
            run(f["name"], lambda: fn(out.data_ptr(), p48.offs.data_ptr(),
                                      p48.wts.data_ptr(), coef.data_ptr(),
                                      consts.ctypes.data, ints.ctypes.data,
                                      stream),
                (coef[:-1],), (ref,), {"threads": th})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
