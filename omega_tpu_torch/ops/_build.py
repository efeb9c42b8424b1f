"""Builds and loads the CUDA kernels of csrc/.

The sources have a plain C interface and include no PyTorch header, so
`nvcc` compiles each in seconds. Every `csrc/*.cu` is compiled to an object
file (one `nvcc` per source, all started together) and the objects are
linked into ONE shared library under `omega_tpu_torch/build/`, named after a
hash of the sources, which `ctypes` loads. Nothing is built when the package
is imported: the first CUDA tensor that needs a kernel triggers `load()`.
A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIB = None
# filled by the build: seconds taken and the compiler's resource report
# (registers, shared memory, spills per kernel), for chip_smoke.py to print
BUILD_INFO = {"seconds": None, "cached": None, "ptxas": ""}


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe:
        return exe
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(looked on PATH, $CUDA_HOME and /usr/local/cuda)")


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/*.cu into build/libomega_kernels_<hash>.so (reused when
    the sources have not changed) and return its path."""
    lib = BUILD_DIR / f"libomega_kernels_{_digest()}.so"
    if lib.exists():
        BUILD_INFO.update(seconds=0.0, cached=True)
        return lib
    t0 = time.perf_counter()
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    objs, procs = [], []
    for src in sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    report, failed = [], []
    for src, proc in procs:
        out, _ = proc.communicate()
        report.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src.name} "
                          f"(exit {proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = BUILD_DIR / f"{tag}.so"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc failed to link {lib.name} "
                           f"(exit {link.returncode}):\n{link.stdout}")
    os.replace(tmp, lib)       # atomic: a concurrent build loses nothing
    for obj in objs:
        obj.unlink(missing_ok=True)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, cached=False,
                      ptxas="".join(report))
    return lib


def load() -> ctypes.CDLL:
    """The kernels' shared library, built at first use."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build()))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name in ("omega_stencil_f32", "omega_stencil_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [vp, vp, vp, vp]       # in, out, params, stream
        fn.restype = ci
    for name in ("omega_stencil_attrs_f32", "omega_stencil_attrs_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ci, vp]               # vector, out[4]
        fn.restype = ci
    cd = ctypes.c_double
    for tails in ("plain", "tails"):
        for suffix in ("f32", "f64"):
            for flux in ("cc", "uc", "cu", "uu", "cf", "uf"):
                fn = getattr(lib, f"omega_fb_step_{flux}_{tails}_{suffix}")
                # in, out, wind, params, threads, stream
                fn.argtypes = [vp, vp, vp, vp, ci, vp]
                fn.restype = ci
                fn = getattr(lib, f"omega_fb_step_attrs_{flux}_{tails}_"
                                  f"{suffix}")
                fn.argtypes = [vp]           # out[4]
                fn.restype = ci
            for flux in ("cc", "uc", "cu", "uu"):
                fn = getattr(lib, f"omega_rk_stage_{flux}_{tails}_{suffix}")
                # ev, base, acc, acc_out, out, wind, params, ca, cb, mode,
                # threads, stream
                fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, cd, cd, ci, ci, vp]
                fn.restype = ci
                fn = getattr(lib, f"omega_rk_stage_attrs_{flux}_{tails}_"
                                  f"{suffix}")
                fn.argtypes = [vp]           # out[4]
                fn.restype = ci
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"omega_split_pre_{suffix}")
        # state, du, planes, params, depth, ggrad, f_e, r, threads, stream
        fn.argtypes = [vp] * 4 + [cd] * 4 + [ci, vp]
        fn.restype = ci
        fn = getattr(lib, f"omega_split_pre_attrs_{suffix}")
        fn.argtypes = [ci, vp]               # pass, out[4]
        fn.restype = ci
        fn = getattr(lib, f"omega_split_post_{suffix}")
        # state, du, planes, out, params, threads, stream
        fn.argtypes = [vp] * 5 + [ci, vp]
        fn.restype = ci
        fn = getattr(lib, f"omega_split_post_attrs_{suffix}")
        fn.argtypes = [vp]                   # out[4]
        fn.restype = ci
        fn = getattr(lib, f"omega_barotropic_{suffix}")
        # in, out, work, params, dt_bt, ggrad, f_e, r, M, grid, stream
        fn.argtypes = [vp] * 4 + [cd] * 4 + [ci, ci, vp]
        fn.restype = ci
        fn = getattr(lib, f"omega_barotropic_attrs_{suffix}")
        fn.argtypes = [ci, vp]               # resident, out[5]
        fn.restype = ci
    lib.omega_split_slots.argtypes = [ci]
    lib.omega_split_slots.restype = ci
    lib.omega_bt_slots.argtypes = []
    lib.omega_bt_slots.restype = ci
    for name in ("omega_pp81_coeffs_f32", "omega_pp81_coeffs_f64",
                 "omega_vmix_solve_f32", "omega_vmix_solve_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [vp, vp, vp, vp, vp]   # state, kappa, nu, params, stream
        fn.restype = ci
    for name in ("omega_vmix_solve_attrs_f32", "omega_vmix_solve_attrs_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [vp, vp]               # params, out[4]
        fn.restype = ci
    for name in ("omega_pp81_coeffs_attrs_f32", "omega_pp81_coeffs_attrs_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [vp]                   # out[4]
        fn.restype = ci
    for name in ("omega_stencil_params_size_f32",
                 "omega_stencil_params_size_f64",
                 "omega_fb_params_size_f32", "omega_fb_params_size_f64",
                 "omega_vmix_params_size_f32",
                 "omega_vmix_params_size_f64"):
        fn = getattr(lib, name)
        fn.argtypes = []
        fn.restype = ci
    for suffix in ("f32", "f64"):
        for flux in ("cc", "uc", "cu", "uu", "cf", "uf"):
            for tails in ("plain", "tails"):
                fn = getattr(lib, f"omega_patch_fb_{flux}_{tails}_{suffix}")
                # in, out, offs, wts, cpl, work, consts, ints, stream
                fn.argtypes = [vp] * 9
                fn.restype = ci
                fn = getattr(lib, f"omega_patch_fb_attrs_{flux}_{tails}_"
                                  f"{suffix}")
                fn.argtypes = [ci, ci, vp]    # pass, threads, out[4]
                fn.restype = ci
        for flux in ("cc", "uc", "cu", "uu"):
            for tails in ("plain", "tails"):
                fn = getattr(lib, f"omega_patch_rk_{flux}_{tails}_{suffix}")
                # ev, base, acc, acc_out, out, offs, wts, cpl, work,
                # consts, ints, stream
                fn.argtypes = [vp] * 12
                fn.restype = ci
                fn = getattr(lib, f"omega_patch_rk_attrs_{flux}_{tails}_"
                                  f"{suffix}")
                fn.argtypes = [ci, vp]        # pass, out[3]
                fn.restype = ci
        for flux in ("c", "u"):
            fn = getattr(lib, f"omega_patch_fct_b_{flux}_{suffix}")
            # mid, in, out, offs, wts, cpl, work, consts, ints, stream
            fn.argtypes = [vp] * 10
            fn.restype = ci
            fn = getattr(lib, f"omega_patch_fct_b_attrs_{flux}_{suffix}")
            fn.argtypes = [ci, ci, vp]        # pass, threads, out[4]
            fn.restype = ci
        for name in ("pp81", "vmix_solve"):
            fn = getattr(lib, f"omega_patch_{name}_{suffix}")
            # frames, offs, wts, coef, consts, ints, stream
            fn.argtypes = [vp] * 7
            fn.restype = ci
        for name in ("pp81", "vmix_solve"):
            fn = getattr(lib, f"omega_patch_{name}_attrs_{suffix}")
            fn.argtypes = [vp] * 3           # consts, ints, out[4]
            fn.restype = ci
        fn = getattr(lib, f"omega_patch_split_pre_{suffix}")
        # in, out, offs, wts, cpl, depth row, work, consts, ints, stream
        fn.argtypes = [vp] * 10
        fn.restype = ci
        fn = getattr(lib, f"omega_patch_split_pre_attrs_{suffix}")
        fn.argtypes = [ci, vp]               # pass, out[3]
        fn.restype = ci
        fn = getattr(lib, f"omega_patch_split_post_attrs_{suffix}")
        fn.argtypes = [ci, ci, vp]           # pass, threads, out[4]
        fn.restype = ci
        fn = getattr(lib, f"omega_patch_split_post_{suffix}")
        # in, out, offs, wts, cpl, work, consts, ints, stream
        fn.argtypes = [vp] * 9
        fn.restype = ci
        fn = getattr(lib, f"omega_bt_gather_{suffix}")
        # the 20 arrays' pointers, consts, ints, stream
        fn.argtypes = [vp] * 4
        fn.restype = ci
        fn = getattr(lib, f"omega_bt_gather_attrs_{suffix}")
        fn.argtypes = [ci, ci, ci, vp]       # resident, threads, list, out[5]
        fn.restype = ci
        fn = getattr(lib, f"omega_gather_{suffix}")
        # field, out, idx, w, ints, stream
        fn.argtypes = [vp] * 6
        fn.restype = ci
    for name in ("omega_patch_rows", "omega_patch_fct_rows"):
        getattr(lib, name).argtypes = [ci]
        getattr(lib, name).restype = ci
    lib.omega_chain_slots.argtypes = [ci, ci]
    lib.omega_chain_slots.restype = ci
    lib.omega_error_string.argtypes = [ci]
    lib.omega_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def check(code: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if code != 0:
        msg = load().omega_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")
