#!/usr/bin/env python3
"""Forms of the two PP81 coefficient kernels, timed on one NVIDIA GPU.

    python3 kernel_forms.py kernel_forms_pp81.json   # from a checkout's root

Each form in the JSON list is one of the checkout's kernel sources
(`file`: vmix.cu for the plane's kernel, patch_vmix.cu for the sphere's)
with text substitutions (`subs`: [old, new] pairs, each of which must
occur), compiled with the package's nvcc flags into a library of its own
and launched through its C entry point on chip_smoke.py's full-width
inputs, float32: the plane at 256 x 256 x 100 x 2 on the state one
science FB step leaves, the sphere at icos48 x 100 x 2 on the frames the
science patch step writes. A plane form runs at each of its `groups`
(the record's groups of interfaces), a sphere form at each of its
`threads` per block. Prints one JSON line per form and setting: ms per
call by CUDA events (three reads of 20 calls), whether its output is the
checkout's own kernel's bit for bit (a form that skips work is not), and
nvcc's registers and spill for it; first the card's name and power limit
and the checkout's own kernels' times. Imports nothing of JAX.
"""

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
        text = (_build.CSRC / f["file"]).read_text()
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
        # nvcc's report of the float32 coefficient kernels in this library
        built[name, "ptxas"] = [
            [lines[i].split("'")[1]] + [x.strip() for x in lines[i + 2:i + 4]]
            for i, ln in enumerate(lines)
            if "Compiling entry function" in ln and "pp81" in ln
            and "If" in ln]

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

    K, L = 100, 2
    put = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    tend = dict(visc_del2=1.0e3, visc_del4=1.0e9)
    science = ModelConfig(
        nvertlayers=K, ntracers=L, flux_thickness_type="upwind",
        flux_tracer_type="upwind",
        vert_mix=VertMixConfig(enabled=True, scheme="pp81", temp_index=0,
                               salt_index=1),
        tendencies=TendencyConfig(wind_forcing=True, bottom_drag=True,
                                  bottom_drag_coeff=3.0e-3, **tend))
    stream = torch.cuda.current_stream().cuda_stream

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
