"""Implicit vertical mixing on the stacked state: the column kernels and
their plain versions.

The fused horizontal kernel (ops/megastep.py) works one layer per block and
cannot see a column, so the vertical-mixing tail of the step runs after it,
in place, on the same stacked (4+L, K, ny, nx) array (csrc/vmix.cu):

  * `pp81_coeffs`  — the Richardson-number closure (core/vmix.
                     pp81_coefficients) on the updated state: kappa_cell
                     (K-1, ny, nx) and nu_edge (3, K-1, ny, nx); launched
                     only for scheme "pp81"
  * `vmix_solve`   — backward-Euler diffusion of every column: the L
                     tracers against the cell thickness, the three edge
                     classes of u against cmean(h); the system of
                     ops/tridiag.pcr, solved by elimination in chunks of
                     rows (csrc/column_solve.cuh, shared with the sphere's
                     solve: a block's columns staged in shared memory, each
                     k-lane's chunk eliminated in place, the chunks' end
                     rows solved together)

They are the counterparts of `_pp81_coeffs` and of `_vmix_apply` with
`_pcr_diffusion` in the JAX package's fused kernel (ops/megastep.py there).
The Thomas method stays with the composed stepper (`vmix_on` is False for
it), as it does there.

Beside each kernel stands its plain PyTorch version (`pp81_coeffs_plain`,
`vmix_solve_plain`, together `vmix_plain`), built from ops/tridiag and
core/vmix. A CPU array takes the plain versions; a CUDA array launches the
kernels or raises. Each kernel counts its launches.
"""

from __future__ import annotations

import numpy as np
import torch

from omega_tpu_torch.core import vmix
from omega_tpu_torch.ops import _build, structured
from omega_tpu_torch.ops.stencil_kernel import (_FLOAT, entry_dtype,
                                                pack_entries)
from omega_tpu_torch.ops.structured import apply_grid

# launches of each CUDA kernel since the last reset (plain integers)
coeff_launches = 0
solve_launches = 0

MAX_ENTRIES = 16      # kVmixMaxEntries in csrc/vmix.cu
SMEM_LIMIT = 232448   # dynamic shared memory one block may use on sm_90
# the column solves (csrc/column_solve.cuh): rows a k-lane holds (kChunk),
# the planar solve's tracers per pass (kSolveRhs), k-lanes of a block at
# most; the sphere's solve (csrc/patch_vmix.cu) takes up to FRAME_RHS
# tracers per pass (kFrameRhs)
SOLVE_CHUNK = 25
SOLVE_RHS = 2
FRAME_RHS = 8
MAX_LANES = 32
EPS = 1.0e-16         # floor of shear^2 in the Richardson number
_REAL_FIELDS = ("dt", "grav", "nu0", "alpha", "a_t", "b_s", "kt0", "km0")
_INT_FIELDS = ("n_exp", "ti", "si", "L", "K", "ny", "nx", "by", "bx", "ry",
               "rx", "cw", "lanes", "groups")
# the coefficient kernel's tile and ring (coef::Geo in csrc/vmix.cu), and the
# blocks its grid aims at (tiles x groups of interfaces): two waves of an
# H100's 132 SMs x 3 blocks of 256 threads, the fastest of 3-12 groups at
# 256 x 256 x 100 (PERF.md)
COEF_TILE = (16, 32)
COEF_RING = (1, 1)
COEF_BLOCKS = 792


def vmix_on(cfg) -> bool:
    """The vertical mixing the column kernels implement: constant or PP81
    coefficients solved by PCR, on at least two layers. (With one layer
    the step mixes nothing; the Thomas method runs composed.)"""
    vm = cfg.vert_mix
    return (vm.enabled and cfg.nvertlayers >= 2
            and vm.scheme in ("constant", "pp81") and vm.method == "pcr"
            and isinstance(vm.n_exp, int) and vm.n_exp >= 0)


def _tables(mesh):
    ke, cmean = (structured.cached_table(mesh, n) for n in ("ke", "cmean"))
    if ke is None or cmean is None:
        raise ValueError("vertical-mixing kernels need the structured "
                         "`ke` and `cmean` tables of the mesh")
    return ke, cmean


def _even(mesh, dev):
    return (torch.arange(mesh.structured_ny, device=dev) % 2 == 0)[:, None]


# ----------------------------------------------------------------------
# the plain versions

def _ipow(f, n: int):
    """f ** n for an integer n >= 0 by repeated multiplication, the form
    the kernel uses."""
    out = torch.ones_like(f)
    for _ in range(n):
        out = out * f
    return out


def pp81_coeffs_plain(mesh, cfg, stacked):
    """core/vmix.pp81_coefficients on the stacked layout: (kappa_cell
    (K-1, ny, nx), nu_edge (3, K-1, ny, nx))."""
    vm = cfg.vert_mix
    ke_tab, cm_tab = _tables(mesh)
    even = _even(mesh, stacked.device)
    h = stacked[0]
    du = [stacked[1 + i][:-1] - stacked[1 + i][1:] for i in range(3)]
    dz = 0.5 * (h[:-1] + h[1:])
    if vm.temp_index >= 0 and vm.salt_index >= 0:
        T, S = stacked[4 + vm.temp_index], stacked[4 + vm.salt_index]
        db = cfg.gravity * (vm.eos_alpha_t * (T[:-1] - T[1:])
                            - vm.eos_beta_s * (S[:-1] - S[1:]))
        n2 = torch.clamp(db / dz, min=0.0)
    else:
        n2 = torch.zeros_like(dz)

    dz_edge = apply_grid(cm_tab, [dz], even, 3)
    ke = apply_grid(ke_tab, [d * d for d in du], even, 1)[0]
    shear2_cell = 2.0 * ke / (dz * dz)
    n2_edge = apply_grid(cm_tab, [n2], even, 3)

    def nu_of(ri):
        f = 1.0 + vm.alpha * torch.clamp(ri, min=0.0)
        return vm.nu0 / _ipow(f, vm.n_exp), f

    nu_c, f = nu_of(n2 / torch.clamp(shear2_cell, min=EPS))
    kappa = nu_c / f + vm.kappa_tracer
    nu = []
    for i in range(3):
        sh = du[i] / dz_edge[i]
        nu_e, _ = nu_of(n2_edge[i] / torch.clamp(sh * sh, min=EPS))
        nu.append(nu_e + vm.kappa_momentum)
    return kappa, torch.stack(nu)


def vmix_solve_plain(mesh, cfg, stacked, dt, coeffs=None):
    """The column solves on the stacked layout, out of place: tracers
    against h, each edge class of u against cmean(h), by ops/tridiag.pcr.
    `coeffs` is None (the constant coefficients of cfg.vert_mix) or the
    (kappa_cell, nu_edge) pair of `pp81_coeffs`."""
    vm = cfg.vert_mix
    _, cm_tab = _tables(mesh)
    s = stacked.permute(0, 2, 3, 1)                  # K last, as tridiag has it
    h = s[0]
    he = [x.permute(1, 2, 0) for x in apply_grid(
        cm_tab, [stacked[0]], _even(mesh, stacked.device), 3)]
    if coeffs is None:
        kt = torch.full_like(h[..., :-1], vm.kappa_tracer)
        km = [torch.full_like(h[..., :-1], vm.kappa_momentum)] * 3
    else:
        kt = coeffs[0].permute(1, 2, 0)
        km = [coeffs[1][i].permute(1, 2, 0) for i in range(3)]
    out = torch.empty_like(stacked)
    out[0] = stacked[0]
    for i in range(3):
        out[1 + i] = vmix.implicit_vmix(he[i], km[i], dt,
                                        s[1 + i]).permute(2, 0, 1)
    out[4:] = vmix.implicit_vmix(h[None], kt[None], dt,
                                 s[4:]).permute(0, 3, 1, 2)
    return out


def vmix_plain(mesh, cfg, stacked, dt):
    """The plain version of `vmix_stacked`, out of place."""
    coeffs = pp81_coeffs_plain(mesh, cfg, stacked) \
        if cfg.vert_mix.scheme == "pp81" else None
    return vmix_solve_plain(mesh, cfg, stacked, dt, coeffs)


# ----------------------------------------------------------------------
# planning and parameters (host python, exercised by the CPU tests)

def plan_chunks(K, itemsize, lc=SOLVE_RHS):
    """A column solve kernel's block: dict(cw, lanes, chunk, smem).

    A column's K rows are cut into `lanes` contiguous chunks of at most
    SOLVE_CHUNK rows, each eliminated by one k-lane (threadIdx.y); the
    fewest lanes that take the column, so every chunk has at least two
    rows. A block takes cw adjacent columns (32, one warp's coalesced
    segment, where cw x lanes <= 256 and the staging fits) and stages per
    pass 2 + max(lc, 2) arrays of K rows x cw (thickness, coefficients, an
    edge's second cell and u, or lc right-hand sides) and the reduced
    system of the chunks' end rows, 2 lanes rows of a, c and lc right-hand
    sides (csrc/column_solve.cuh: column_smem_elems)."""
    lanes = -(-K // SOLVE_CHUNK)
    if K >= 2 and lanes <= MAX_LANES and lc >= 1:
        for cw in (32, 16, 8):
            smem = ((2 + max(lc, 2)) * K + (2 + lc) * 2 * lanes) * cw \
                * itemsize
            if cw * lanes <= 256 and smem <= SMEM_LIMIT:
                return dict(cw=cw, lanes=lanes, chunk=-(-K // lanes),
                            smem=smem)
    raise ValueError(f"{K} layers do not fit the solve kernel")


def plan_frames(K, L, itemsize):
    """The sphere's solve kernel's block (csrc/patch_vmix.cu): plan_chunks'
    keys for lc tracers per pass, and `rhs`, the width of the kernel that
    runs it (SOLVE_RHS, or FRAME_RHS for more tracers than that). All L
    tracers go in one pass where the staging fits (at most FRAME_RHS),
    else as many as it takes."""
    for lc in range(min(max(L, 1), FRAME_RHS), 0, -1):
        try:
            plan = plan_chunks(K, itemsize, lc)
        except ValueError:
            continue
        return dict(plan, lc=lc,
                    rhs=SOLVE_RHS if lc <= SOLVE_RHS else FRAME_RHS)
    raise ValueError(f"{K} layers do not fit the sphere's solve kernel")


def plan_coeffs(ny, nx, K):
    """The coefficient kernel's plan: dict(by, bx, ry, rx, groups). The
    tile and ring are the compiled ones (COEF_TILE, COEF_RING; the ring is
    the reach of the hex mesh's `ke` and `cmean` entries); a block walks
    one group of interfaces of its tile, and the groups are as many as
    bring the grid near COEF_BLOCKS blocks (each group reads its first
    layer once more), none of them empty."""
    by, bx = COEF_TILE
    tiles = -(-ny // by) * -(-nx // bx)
    groups = max(1, min(K - 1, round(COEF_BLOCKS / tiles)))
    groups = -(-(K - 1) // -(-(K - 1) // groups))
    return dict(by=by, bx=bx, ry=COEF_RING[0], rx=COEF_RING[1],
                groups=groups)


def _params_dtype(ft) -> np.dtype:
    """numpy mirror of `omega::VmixParams<T>` (csrc/vmix.cu)."""
    return np.dtype([("e", entry_dtype(ft), (MAX_ENTRIES,)),
                     ("nke", "i4"), ("cm_start", "i4", (4,))]
                    + [(n, ft) for n in _REAL_FIELDS]
                    + [(n, "i4") for n in _INT_FIELDS], align=True)


def pack_params(mesh, cfg, dt, ft, L, K):
    """Tables, constants and both kernels' plans as one VmixParams record."""
    vm = cfg.vert_mix
    nx, ny = mesh.structured_nx, mesh.structured_ny
    ke_tab, cm_tab = _tables(mesh)
    ke_ent, _ = pack_entries(ke_tab, 1, ft)
    cm_ent, cm_start = pack_entries(cm_tab, 3, ft)
    n = len(ke_ent) + len(cm_ent)
    if n > MAX_ENTRIES:
        raise ValueError(f"the ke and cmean tables have {n} entries; the "
                         f"kernels take {MAX_ENTRIES}")
    if any(c > 2 for c in np.diff(cm_start)):
        raise ValueError("an edge thickness must be a two-cell mean")
    if vm.temp_index >= L or vm.salt_index >= L:
        raise ValueError("temp_index / salt_index exceed the tracer count")
    rec = np.zeros((), _params_dtype(ft))
    rec["e"][:len(ke_ent)] = ke_ent
    rec["e"][len(ke_ent):n] = cm_ent
    rec["nke"] = len(ke_ent)
    rec["cm_start"] = len(ke_ent) + cm_start
    rec["dt"], rec["grav"] = dt, cfg.gravity
    rec["nu0"], rec["alpha"], rec["n_exp"] = vm.nu0, vm.alpha, vm.n_exp
    rec["a_t"], rec["b_s"] = vm.eos_alpha_t, vm.eos_beta_s
    rec["kt0"], rec["km0"] = vm.kappa_tracer, vm.kappa_momentum
    rec["ti"], rec["si"] = vm.temp_index, vm.salt_index
    rec["L"], rec["K"], rec["ny"], rec["nx"] = L, K, ny, nx
    plan = plan_coeffs(ny, nx, K)
    plan.update(plan_chunks(K, np.dtype(ft).itemsize))
    for k in ("by", "bx", "ry", "rx", "cw", "lanes", "groups"):
        rec[k] = plan[k]
    return rec


# ----------------------------------------------------------------------
# the kernels' wrappers

_PARAM_CACHE: dict = {}


def _checked(mesh, cfg, stacked, dt):
    """(lib, rec, suffix) for a stacked CUDA state, or raise."""
    if stacked.dtype not in _FLOAT:
        raise TypeError(f"vertical-mixing kernels take float32/float64, "
                        f"got {stacked.dtype}")
    nx, ny = mesh.structured_nx, mesh.structured_ny
    if stacked.ndim != 4 or stacked.shape[0] < 4 or stacked.shape[1] < 2 \
            or tuple(stacked.shape[2:]) != (ny, nx):
        raise ValueError(f"stacked state must be (4+L, K >= 2, {ny}, {nx}), "
                         f"got {tuple(stacked.shape)}")
    if not stacked.is_contiguous():
        raise ValueError("stacked state must be contiguous")
    ft, suffix = _FLOAT[stacked.dtype]
    L, K = stacked.shape[0] - 4, stacked.shape[1]
    key = (nx, ny, mesh.structured_dc, cfg.vert_mix, cfg.gravity, float(dt),
           suffix, L, K)
    rec = _PARAM_CACHE.get(key)
    if rec is None:
        rec = _PARAM_CACHE[key] = pack_params(mesh, cfg, dt, ft, L, K)
    lib = _build.load()
    size = getattr(lib, f"omega_vmix_params_size_{suffix}")()
    if size != rec.dtype.itemsize:
        raise RuntimeError(f"VmixParams layout mismatch: kernel {size} "
                           f"bytes, host {rec.dtype.itemsize}")
    return lib, rec, suffix


def _check_pattern(mesh):
    """The coefficient kernel is compiled for the planar hex mesh's entry
    pattern, as the fused steps that call it are (their gate,
    megastep.supported); any other mesh raises here."""
    from omega_tpu_torch.ops import megastep     # megastep imports this
    if not megastep.hex_pattern_fits(mesh):
        raise ValueError("the PP81 coefficient kernel takes the planar hex "
                         "mesh's entry pattern only "
                         "(megastep.hex_pattern_fits)")


def pp81_coeffs(mesh, cfg, stacked):
    """(kappa_cell (K-1, ny, nx), nu_edge (3, K-1, ny, nx)) of the PP81
    closure on a stacked state: one kernel launch on PyTorch's current
    stream for a CUDA array, the plain version for a CPU array."""
    global coeff_launches
    if not stacked.is_cuda:
        return pp81_coeffs_plain(mesh, cfg, stacked)
    _check_pattern(mesh)
    lib, rec, suffix = _checked(mesh, cfg, stacked, 0.0)
    K, ny, nx = stacked.shape[1:]
    kappa = stacked.new_empty((K - 1, ny, nx))
    nu = stacked.new_empty((3, K - 1, ny, nx))
    with torch.cuda.device(stacked.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, f"omega_pp81_coeffs_{suffix}")(
            stacked.data_ptr(), kappa.data_ptr(), nu.data_ptr(),
            rec.ctypes.data, stream)
    _build.check(code, "PP81 coefficient kernel launch")
    coeff_launches += 1
    return kappa, nu


def vmix_solve(mesh, cfg, stacked, dt, coeffs=None):
    """The column solves IN PLACE on the u and tracer channels of a stacked
    state (h is read only); returns `stacked`. One kernel launch on
    PyTorch's current stream for a CUDA array, the plain version for a
    CPU array. `coeffs` as in `vmix_solve_plain`."""
    global solve_launches
    if not stacked.is_cuda:
        stacked.copy_(vmix_solve_plain(mesh, cfg, stacked, dt, coeffs))
        return stacked
    lib, rec, suffix = _checked(mesh, cfg, stacked, dt)
    K, ny, nx = stacked.shape[1:]
    kappa = nu = None
    if coeffs is not None:
        kappa, nu = coeffs
        for a, shape in ((kappa, (K - 1, ny, nx)), (nu, (3, K - 1, ny, nx))):
            if (tuple(a.shape) != shape or a.dtype != stacked.dtype
                    or a.device != stacked.device or not a.is_contiguous()):
                raise ValueError(f"a coefficient array must be a contiguous "
                                 f"{shape} array of the state's type and "
                                 "device")
    with torch.cuda.device(stacked.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, f"omega_vmix_solve_{suffix}")(
            stacked.data_ptr(),
            None if kappa is None else kappa.data_ptr(),
            None if nu is None else nu.data_ptr(), rec.ctypes.data, stream)
    _build.check(code, "vertical-mixing solve kernel launch")
    solve_launches += 1
    return stacked


def coeff_attrs(dtype):
    """cudaFuncGetAttributes' numRegs, localSizeBytes (the spill) and
    sharedSizeBytes of the coefficient kernel in `dtype`, and the blocks an
    SM holds of it."""
    suffix = _FLOAT[dtype][1]
    got = np.zeros(4, np.int32)
    _build.check(getattr(_build.load(), f"omega_pp81_coeffs_attrs_{suffix}")(
        got.ctypes.data), "cudaFuncGetAttributes")
    return dict(zip(("num_regs", "local_bytes", "shared_bytes",
                     "blocks_per_sm"), map(int, got)))


def solve_attrs(mesh, cfg, stacked):
    """cudaFuncGetAttributes' numRegs, localSizeBytes (the spill) and
    sharedSizeBytes of the solve kernel in the state's type, and the blocks
    an SM holds for this state's plan."""
    lib, rec, suffix = _checked(mesh, cfg, stacked, 0.0)
    got = np.zeros(4, np.int32)
    _build.check(getattr(lib, f"omega_vmix_solve_attrs_{suffix}")(
        rec.ctypes.data, got.ctypes.data), "cudaFuncGetAttributes")
    return dict(zip(("num_regs", "local_bytes", "shared_bytes",
                     "blocks_per_sm"), map(int, got)))


def vmix_stacked(mesh, cfg, stacked, dt):
    """Operator-split vertical mixing of a stacked state, in place
    (steppers._mix on the fused path): the PP81 coefficient pass where the
    scheme asks for it, then the column solves."""
    coeffs = pp81_coeffs(mesh, cfg, stacked) \
        if cfg.vert_mix.scheme == "pp81" else None
    return vmix_solve(mesh, cfg, stacked, dt, coeffs)
