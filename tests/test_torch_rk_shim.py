"""The planar RK stage kernel (csrc/rk_stage.cuh through rk_stage_cc.cu and
rk_stage_uu.cu) compiled for the CPU by g++ against the stand-in for the CUDA
runtime of tests/test_torch_sphere_split_shim.py, with a block-level launch:
each block's threads run as fibers (`ucontext`) on the calling thread, one
after another up to the next `__syncthreads()`, which passes when every
thread has met it, and the block's dynamic shared array is one buffer per
block, filled with NaN bytes before the block starts (a read of a slot no
level wrote, or one a later thread writes before the barrier, shows). Run
on CPU tensors against the kernel's plain version
(ops/megastep.rk_stage_plain) on a 32 x 16 planar hex mesh, 3
layers, 2 tracers: every stage mode (RK_PROV, RK_FIRST, RK_MID, RK_LAST),
center fluxes without tails and upwind fluxes with the wind / drag tails
(and the other two pairings), float64 and float32; then the arguments a
launch refuses, and the host's check of the entry pattern.

Limits (the card's, chip_smoke.py's `kernel_rk`): float64 per channel
max|diff| <= 1e-12 max|ref| of `out` and of the accumulator; float32 per
channel the error of the increment (what the stage changed against what it
starts from) <= RK_INCR = 0.02 of the largest increment. What the card alone
can show (the build by nvcc, the launch, the times) is chip_smoke.py's
`kernel_rk`."""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from test_torch_sphere_split_shim import CSRC, RUNTIME

from omega_tpu_torch.core import ModelConfig, ModelState, TendencyConfig
from omega_tpu_torch.mesh import planar_hex_mesh
from omega_tpu_torch.ops import megastep, structured

NX, NY, K, L, DT = 32, 16, 3, 2, 30.0
F64_TOL, RK_INCR = 1e-12, 0.02
DTYPES = {"f64": torch.float64, "f32": torch.float32}
FLUX = {"cc": {}, "uu": dict(flux_thickness_type="upwind",
                             flux_tracer_type="upwind")}
WIND_DRAG = dict(wind_forcing=True, bottom_drag=True, bottom_drag_coeff=3e-3)
MODES = {"prov": megastep.RK_PROV, "first": megastep.RK_FIRST,
         "mid": megastep.RK_MID, "last": megastep.RK_LAST}
CA, CB = 0.5 * DT, DT / 3.0

BLOCK_RUNTIME = RUNTIME + r"""
#include <ucontext.h>
#include <cstring>
#include <memory>
#include <vector>
#define __align__(n) alignas(n)
#define __syncthreads() shim::sync()
enum {
  cudaErrorInvalidConfiguration = 9,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8
};
template <class F>
cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
namespace shim {
// a block's threads are fibers on the calling thread: each runs until it
// meets __syncthreads() (or ends), then the next one runs; a barrier is
// passed when every fiber has reached it
inline thread_local unsigned char* dyn = nullptr;
inline thread_local ucontext_t* sched = nullptr;
inline thread_local ucontext_t* cur = nullptr;
inline thread_local void (*body)(void*) = nullptr;
inline thread_local void* body_arg = nullptr;
inline thread_local char* done = nullptr;
inline thread_local unsigned cur_t = 0;
inline void sync() { swapcontext(cur, sched); }
inline void trampoline() {
  body(body_arg);
  done[cur_t] = 1;
}
// the grid's blocks one after another, each block's threads side by side
// (fibers switched at every barrier), the dynamic shared array one buffer
// filled with NaN bytes before each block
template <class F>
cudaError_t run_blocks(dim3 g, dim3 b, size_t smem, void*, F f) {
  const unsigned nt = b.x * b.y * b.z;
  constexpr size_t kStack = 1 << 18;
  std::vector<double> buf(smem / sizeof(double) + 1);
  std::vector<std::unique_ptr<char[]>> stacks(nt);
  for (auto& s : stacks) s.reset(new char[kStack]);
  std::vector<ucontext_t> ctx(nt);
  std::vector<char> fin(nt);
  ucontext_t main_ctx;
  gridDim = g;
  blockDim = b;
  dyn = reinterpret_cast<unsigned char*>(buf.data());
  sched = &main_ctx;
  done = fin.data();
  body = [](void* a) { (*static_cast<F*>(a))(); };
  body_arg = &f;
  for (unsigned z = 0; z < g.z; ++z)
    for (unsigned y = 0; y < g.y; ++y)
      for (unsigned x = 0; x < g.x; ++x) {
        std::memset(buf.data(), 0xff, buf.size() * sizeof(double));
        blockIdx = dim3(x, y, z);
        for (unsigned t = 0; t < nt; ++t) {
          getcontext(&ctx[t]);
          ctx[t].uc_stack.ss_sp = stacks[t].get();
          ctx[t].uc_stack.ss_size = kStack;
          ctx[t].uc_link = &main_ctx;
          makecontext(&ctx[t], trampoline, 0);
          fin[t] = 0;
        }
        for (bool live = true; live;) {
          live = false;
          for (unsigned t = 0; t < nt; ++t) {
            if (fin[t]) continue;
            live = true;
            threadIdx = dim3(t % b.x, t / b.x % b.y, t / (b.x * b.y));
            cur = &ctx[t];
            cur_t = t;
            swapcontext(&main_ctx, &ctx[t]);
          }
        }
      }
  return 0;
}
}  // namespace shim
"""
# kern<<<grid, block, smem, stream>>>(args); -> a block-level launch
BLOCK_LAUNCH = re.compile(
    r"([A-Za-z_]\w*(?:<[^<>;]*>)?)<<<([^;]+?)>>>\(([^;]*)\);")
DYN_SMEM = re.compile(r"extern __shared__[^;]*?(\w+)\[\];")


def _block_source(text):
    text = DYN_SMEM.sub(r"unsigned char* \1 = shim::dyn;", text)
    return BLOCK_LAUNCH.sub(
        lambda m: f"shim::run_blocks({m.group(2)}, [&] {{ "
                  f"{m.group(1)}({m.group(3)}); }});", text)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """rk_stage_cc.cu and rk_stage_uu.cu built by g++ (side by side) into
    one library."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernels for the CPU")
    d = tmp_path_factory.mktemp("planar_rk_shim")
    (d / "include").mkdir()
    (d / "include" / "cuda_runtime.h").write_text(BLOCK_RUNTIME)
    for f in CSRC.glob("*.cu*"):
        (d / f.name).write_text(_block_source(f.read_text()))
    procs = [subprocess.Popen(
        [gxx, "-std=c++20", "-O1", "-fPIC", "-pthread", "-c", "-w",
         f"-I{d / 'include'}", "-x", "c++", str(d / f"rk_stage_{fl}.cu"),
         "-o", str(d / f"{fl}.o")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for fl in FLUX]
    for p in procs:
        out, _ = p.communicate(timeout=900)
        assert p.returncode == 0, out[-4000:]
    so = d / "libplanar_rk_shim.so"
    r = subprocess.run([gxx, "-shared", "-pthread", "-o", str(so)]
                       + [str(d / f"{fl}.o") for fl in FLUX],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    out = ctypes.CDLL(str(so))
    vp, cd, ci = ctypes.c_void_p, ctypes.c_double, ctypes.c_int
    for fl in FLUX:
        for tl in ("plain", "tails"):
            for suf in DTYPES:
                fn = getattr(out, f"omega_rk_stage_{fl}_{tl}_{suf}")
                fn.argtypes = [vp] * 7 + [cd, cd, ci, ci, vp]
                fn.restype = ci
    return out


@pytest.fixture(scope="module")
def mesh_np():
    return planar_hex_mesh(NX, NY, dc=5000.0, f0=1e-4, bottom_depth=1000.0)


def _setup(mesh_np, fl, tails, dtype):
    """(mesh, cfg, wind plane, state, prov, acc): chip_smoke.py's noisy
    state, and the provisional state and accumulator a plain first stage
    makes of it."""
    mesh = mesh_np.to("cpu", dtype)
    cfg = ModelConfig(nvertlayers=K, ntracers=L, **FLUX[fl],
                      tendencies=TendencyConfig(
                          visc_del2=1e3, visc_del4=1e9,
                          **(WIND_DRAG if tails else {})))
    rng = np.random.default_rng(11)
    kx, ky = 2 * np.pi / mesh_np.x_period, 2 * np.pi / mesh_np.y_period
    x, y = np.asarray(mesh_np.x_cell), np.asarray(mesh_np.y_cell)
    h = (1000.0 + np.sin(kx * x) * np.sin(ky * y))[:, None] / K \
        * np.ones((1, K))
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    st = ModelState(t(h), t(0.01 * rng.standard_normal((mesh_np.nedges, K))),
                    t(10.0 + rng.standard_normal((L, mesh_np.ncells, K))))
    s = megastep.stack_state(mesh, st)
    plane = None
    if tails:
        plane = megastep.stack_wind(mesh, cfg, (
            t(0.1 * np.sin(ky * y)), t(0.05 * np.ones(mesh_np.ncells))),
            dtype)
    acc, prov = megastep.rk_stage_plain(mesh, cfg, megastep.RK_FIRST, CA,
                                        DT / 6.0, s, s, wind=plane)
    return mesh, cfg, plane, s, prov, acc


def _call(lib, mesh, cfg, mode, s, prov, acc, plane, out, acc_out,
          threads=None, rec=None, name=None):
    """one launch of `mode` on the inputs a step gives it; its return code"""
    ev = s if mode in (megastep.RK_PROV, megastep.RK_FIRST) else prov
    r, th, nm, _, _ = megastep.launch_record(mesh, cfg, 0.0, ev, plane,
                                             "rk")
    ptr = lambda a: None if a is None else a.data_ptr()
    return getattr(lib, name or nm)(
        ev.data_ptr(), ptr(None if mode == megastep.RK_LAST else s),
        ptr(acc if mode in (megastep.RK_MID, megastep.RK_LAST) else None),
        ptr(acc_out if mode in (megastep.RK_FIRST, megastep.RK_MID)
            else None), ptr(out), ptr(plane),
        (r if rec is None else rec).ctypes.data, CA, CB, mode,
        th if threads is None else threads, None)


def _chan(got, ref):
    return max(((got[c] - ref[c]).abs().max()
                / ref[c].abs().max().clamp(min=1e-300)).item()
               for c in range(ref.shape[0]))


def _incr(got, ref, start):
    return max(((got[c] - ref[c]).abs().max()
                / (ref[c] - start[c]).abs().max().clamp(min=1e-300)).item()
               for c in range(ref.shape[0]))


@pytest.mark.parametrize("suf", list(DTYPES))
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("fl,tails", [("cc", False), ("uu", True),
                                      ("cc", True), ("uu", False)],
                         ids=["cc_plain", "uu_tails", "cc_tails",
                              "uu_plain"])
def test_rk_stage_against_plain(lib, mesh_np, fl, tails, mode, suf):
    """One launch against rk_stage_plain: `out` and, for RK_FIRST / RK_MID,
    the accumulator (RK_MID updates it in place, as the RK4 step does)."""
    dtype = DTYPES[suf]
    mesh, cfg, plane, s, prov, acc = _setup(mesh_np, fl, tails, dtype)
    md = MODES[mode]
    ev = s if md in (megastep.RK_PROV, megastep.RK_FIRST) else prov
    ref_acc, ref = megastep.rk_stage_plain(
        mesh, cfg, md, CA, CB, ev, None if md == megastep.RK_LAST else s,
        acc if md in (megastep.RK_MID, megastep.RK_LAST) else None,
        wind=plane)
    out = torch.full_like(s, float("nan"))
    acc_out = acc.clone() if md == megastep.RK_MID \
        else torch.full_like(s, float("nan"))
    assert _call(lib, mesh, cfg, md, s, prov, acc, plane, out, acc_out) == 0
    # what the outputs are increments of: the state, or in RK_LAST the
    # accumulator's h, u and tracers (tr*h over h); the accumulator's input
    pairs = [(out, ref, s if md != megastep.RK_LAST
              else torch.cat([acc[:4], acc[4:] / acc[0]]))]
    if ref_acc is not None:
        pairs.append((acc_out, ref_acc, acc if md == megastep.RK_MID
                      else torch.cat([s[:4], s[4:] * s[0]])))
    for got, want, start in pairs:
        assert bool(torch.isfinite(got).all())
        if dtype == torch.float64:
            assert _chan(got, want) <= F64_TOL
        else:
            assert _incr(got, want, start) <= RK_INCR


def test_tiled_plain_is_the_kernel_cut(mesh_np):
    """rk_stage_plain tiled as the kernel cuts (HEX_TILE with the chain's
    ring, larger than this domain in x: ragged) equals the whole grid."""
    mesh, cfg, plane, s, prov, acc = _setup(mesh_np, "uu", True,
                                            torch.float64)
    small = planar_hex_mesh(16, 8, dc=5000.0, f0=1e-4,
                            bottom_depth=1000.0).to("cpu", torch.float64)
    for m, st in ((mesh, s), (small, megastep.stack_state(
            small, ModelState(torch.full((small.ncells, K), 300.0),
                              0.01 * torch.ones(small.nedges, K),
                              torch.full((L, small.ncells, K), 10.0))))):
        whole = megastep.tend_plain(m, cfg, st)
        assert torch.equal(megastep.tend_plain(
            m, cfg, st, tile=megastep.HEX_TILE[:2]), whole)


# case -> what it changes in a valid RK_MID call of the plain center-flux
# float64 kernel
REFUSED = {
    "mode_below": dict(mode=-1),
    "mode_above": dict(mode=megastep.RK_LAST + 1),
    "threads_128": dict(threads=128),
    "threads_512": dict(threads=512),
    "wind_without_tails": dict(wind=True),
    "no_acc": dict(null="acc"),
    "no_acc_out": dict(null="acc_out"),
    "out_is_level": dict(alias=True),
    "other_tile": dict(tile=(8, 32)),
    "other_pattern": dict(pattern=True),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_rk_stage_refuses_bad_arguments(lib, mesh_np, case):
    """A call the stage does not take returns an error code and writes
    nothing: a mode out of range, a block of other than 256 threads, the
    wind asked of the instantiation without tails, a missing accumulator,
    `out` aliasing the level it reads at neighbours, a record packed for
    another tile or another entry pattern than the compiled ones."""
    mesh, cfg, _, s, prov, acc = _setup(mesh_np, "cc", False, torch.float64)
    bad = REFUSED[case]
    mode = bad.get("mode", megastep.RK_MID)
    rec = megastep.launch_record(mesh, cfg, 0.0, prov, None, "rk")[0]
    rec = rec.copy()
    if "tile" in bad:
        tabs, consts = megastep._mega_args(mesh, cfg, 0.0)
        plan = megastep.plan_tile(NY, NX, 8, megastep._ring(
            tabs, consts, None, "rk"), bad["tile"], megastep.RK_SLOTS)
        rec = megastep.pack_params(tabs, consts, np.float64, plan)
        rec["L"], rec["K"], rec["ny"], rec["nx"] = L, K, NY, NX
    if bad.get("pattern"):
        rec["off"][1, 3] += 1
    out = torch.zeros_like(s)
    acc_out = torch.zeros_like(s)
    args = dict(acc=acc, acc_out=acc_out)
    if "null" in bad:
        args[bad["null"]] = None
    ptr = lambda a: None if a is None else a.data_ptr()
    ev = prov
    wind = torch.zeros((3, NY, NX), dtype=torch.float64) \
        if bad.get("wind") else None
    code = lib.omega_rk_stage_cc_plain_f64(
        ev.data_ptr(), s.data_ptr(), ptr(args["acc"]), ptr(args["acc_out"]),
        ev.data_ptr() if bad.get("alias") else out.data_ptr(), ptr(wind),
        rec.ctypes.data, CA, CB, mode, bad.get("threads", 256), None)
    assert code != 0
    assert (out == 0).all() and (acc_out == 0).all()


def test_supported_needs_the_compiled_entry_pattern(mesh_np, monkeypatch):
    """The RK steppers and the FB step fuse only where the tables pack
    into the compiled pattern (HEX_PATTERN, which both kernels share);
    otherwise all three run composed."""
    mesh = mesh_np.to("cpu", torch.float64)
    cfg = ModelConfig(nvertlayers=K, ntracers=L,
                      tendencies=TendencyConfig(visc_del2=1e3, visc_del4=1e9))
    assert megastep.hex_pattern_fits(mesh)
    assert all(megastep.supported(mesh, cfg, kind)
               for kind in ("fb", "rk2", "rk4"))
    real = structured.cached_table

    def swapped(m, name):
        tab = real(m, name)
        if name != "tang":
            return tab
        # two entries of class 0: the same counts, another order
        return (tab[3],) + tab[1:3] + (tab[0],) + tab[4:]
    monkeypatch.setattr(structured, "cached_table", swapped)
    assert not megastep.hex_pattern_fits(mesh)
    assert not megastep.supported(mesh, cfg, "fb")
    assert not megastep.supported(mesh, cfg, "rk2")
    assert not megastep.supported(mesh, cfg, "rk4")
