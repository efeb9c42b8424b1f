"""The whole forward-backward step as ONE kernel (mega-step).

The composed step makes ~27 stencil passes, each reading and writing whole
fields in device memory. The fused kernel (csrc/fb_step.cuh) reads h, u and
the tracers once per tile (with a halo ring), computes every auxiliary
variable and tendency term in shared memory, and writes h_new, u_new and
tr_new once — the minimal-traffic formulation of the step. It is the
counterpart of the JAX package's `megastep._kernel` with `_fb_compute`.

Mechanics:
  * state lives in ONE stacked (4+L, K, ny, nx) array, x fastest (channel
    0 = h, 1..3 = the edge classes of u, 4.. = tracers); `run_steps` keeps
    that layout across a whole segment in two buffers that swap roles, so
    a step is exactly one kernel launch
  * the chain couples no two layers (stacked ssh), so a block of the
    kernel is one layer x one (by, bx) tile with a (ry, rx) ring; the
    periodic wrap is index arithmetic
  * inside the slab every structured-table stencil is a shifted read; a
    read that leaves the slab returns a wrong value, so wrong values creep
    in from the slab edge by one stencil radius per level, and the owned
    centre stays exact because the ring is at least the chain radius
    (`chain_radius`, derived from the chain itself)
  * supported configuration = the FB step on a structured f-plane mesh
    with uniform geometry, stacked ssh and every tendency term on, with
    center or upwind thickness and tracer fluxes, wind forcing, quadratic
    bottom drag and implicit vertical mixing (constant or PP81
    coefficients, PCR); anything else (FCT, column ssh, the Thomas
    method) runs the composed stepper (steppers.py)
  * the flux types and the wind / drag tails are compile-time variants of
    the kernel (csrc/fb_step.cuh), so the flagship chain stays as it was;
    vertical mixing couples the layers, which a one-layer block cannot
    see, so it runs as column kernels AFTER the horizontal one on the same
    stacked array (ops/vmix_kernel.py): a step is one launch, or three
    with PP81 mixing

Beside the kernel stands its plain PyTorch version, `fb_megastep_plain`:
the same chain from the same tables and constants with `torch.roll` on the
whole periodic grid, or tile by tile (`tile=(by, bx)`) exactly as the
kernel cuts and evaluates its slabs. The CPU tests use it; a state on the
card never does.
"""

from __future__ import annotations

import numpy as np
import torch

from omega_tpu_torch.core import aux as auxmod
from omega_tpu_torch.ops import _build, structured, vmix_kernel
from omega_tpu_torch.ops.stencil_kernel import pack_entries
from omega_tpu_torch.ops.structured import apply_grid

# launches of the CUDA kernel since the last reset (a plain integer)
launches = 0

# table order of `enum FbTable` in csrc/fb_step.cuh
TABLE_NAMES = ("div", "ke", "curl", "kite", "tang", "cdiff", "cmean",
               "vdiff", "vmean", "signed_div", "c0", "c1")
_PD = {"div": 1, "ke": 1, "curl": 2, "kite": 2, "tang": 3, "cdiff": 3,
       "cmean": 3, "vdiff": 3, "vmean": 3, "signed_div": 1, "c0": 3, "c1": 3}
# entries per destination class the kernel is compiled for (kCount there)
_ENTRY_COUNTS = {"div": 6, "ke": 6, "curl": 3, "kite": 3, "tang": 8,
                 "cdiff": 2, "cmean": 2, "vdiff": 2, "vmean": 2,
                 "signed_div": 6, "c0": 1, "c1": 1}
# scalar constants of `omega::FbParams<T>`, in the struct's order
CONST_FIELDS = ("dt", "grav", "nu2s", "nu4s", "div_factor", "ed2s", "ed4",
                "inv_dc", "inv_dv", "inv_dv_floor", "geo", "geo4", "f0v",
                "rho0", "cd")
MAX_ENTRIES = 96      # kFbMaxEntries
SLOTS = 21            # kFbSlots: slab arrays live in shared memory
SMEM_LIMIT = 232448   # dynamic shared memory one block may use on sm_90
_FLOAT = {torch.float32: (np.float32, "f32"), torch.float64: (np.float64, "f64")}

def enabled(state) -> bool:
    """The fused kernel serves states that live on a CUDA device."""
    return state.h.is_cuda


def supported(mesh, cfg) -> bool:
    """The configurations the fused path implements: stacked ssh, every
    tendency term on, center or upwind fluxes, wind, drag, and vertical
    mixing as far as the column kernels take it (vmix_kernel.vmix_on)."""
    tc = cfg.tendencies
    if not structured.enabled(mesh):
        return False
    if cfg.vert_mix.enabled and not vmix_kernel.vmix_on(cfg):
        return False
    need = ("dc_edge", "dv_edge", "area_cell", "area_triangle", "f_vertex",
            "bottom_depth", "edge_mask", "mesh_scaling_del2",
            "mesh_scaling_del4")
    if any(structured.uniform_scalar(mesh, a) is None for a in need):
        return False
    if structured.uniform_scalar(mesh, "edge_mask") != 1.0:
        return False
    for n in TABLE_NAMES:
        tab = structured.cached_table(mesh, n)
        if tab is None:
            return False
        # the kernel's stencil loops are unrolled for the hex mesh's counts
        if any(sum(1 for e in tab if e[0] == t) != _ENTRY_COUNTS[n]
               for t in range(_PD[n])):
            return False
    return (cfg.flux_thickness_type in ("center", "upwind")
            and cfg.flux_tracer_type in ("center", "upwind")
            and cfg.ssh_formulation == "stacked"
            and tc.thickness_flux_div and tc.pv_advection and tc.ke_gradient
            and tc.ssh_gradient and tc.velocity_diffusion
            and tc.velocity_hyperdiff and tc.tracer_horz_adv
            and tc.tracer_diffusion and tc.tracer_hyperdiff
            and not tc.use_custom_tendency)


def _mega_args(mesh, cfg, dt):
    """(tabs, consts): the shift tables and the constants of the chain.
    Products of constants are folded in float64 here and rounded to the
    working type once, as a float32 array times python floats does.
    `uph` / `upt` (upwind thickness / tracer flux) pick the variant; `cd`
    is the drag coefficient, 0 without bottom drag."""
    tc = cfg.tendencies
    us = lambda a: structured.uniform_scalar(mesh, a)
    dc, dv = us("dc_edge"), us("dv_edge")
    scal2, scal4 = us("mesh_scaling_del2"), us("mesh_scaling_del4")
    geo = dv / dc                                  # edge_mask == 1
    consts = dict(
        dt=float(dt), grav=cfg.gravity,
        nu2s=tc.visc_del2 * scal2, nu4s=tc.visc_del4 * scal4,
        div_factor=tc.div_factor,
        ed2s=tc.eddy_diff2 * scal2, ed4=tc.eddy_diff4,
        inv_dc=1.0 / dc, inv_dv=1.0 / dv,
        inv_dv_floor=1.0 / max(dv, 0.25 * dc),
        geo=geo, geo4=geo * scal4, f0v=us("f_vertex"),
        rho0=tc.density0,
        cd=tc.bottom_drag_coeff if tc.bottom_drag else 0.0,
        uph=cfg.flux_thickness_type == "upwind",
        upt=cfg.flux_tracer_type == "upwind")
    tabs = {n: structured.cached_table(mesh, n) for n in TABLE_NAMES}
    return tabs, consts


# ----------------------------------------------------------------------
# tile and ring planning (host python, exercised by the CPU tests)

_RADIUS_CACHE: dict = {}


def _probe_sel(u, a, b):
    """`aux._upwind` for the radius probe: a pick depends on all three
    operands, whichever the sign of u chooses on this data."""
    return u + a + b


def chain_radius(tabs, uph=False, upt=False, tails=False):
    """(rows, columns) of ring the FB chain needs: the least margin that
    keeps a slab's centre exact when a shifted read that leaves the slab
    returns a wrong value. One answer per variant of the chain (upwind
    thickness flux, upwind tracer flux, wind and drag tails).

    Derived from the chain itself: the plain chain runs once on a small
    slab of ones framed by NaNs, so every value that such a read could
    reach turns NaN level by level, exactly as wrong values creep into the
    kernel's slab. (An upwind pick and the drag's clamp would let a NaN
    operand pass on some data, so the probe replaces the pick by the sum
    of its operands and the chain clamps with a NaN-keeping function.)
    The distance from the frame to the finite region of the outputs, over
    both row parities of the slab origin, is the ring."""
    key = (tuple((n, tuple(tabs[n])) for n in TABLE_NAMES), uph, upt, tails)
    if key in _RADIUS_CACHE:
        return _RADIUS_CACHE[key]
    pad = max(max(abs(v) for v in e[2:5]) for n in TABLE_NAMES
              for e in tabs[n])
    n = 32
    size = n + 2 * pad
    consts = dict.fromkeys(CONST_FIELDS, 1.0)
    consts.update(uph=uph, upt=upt, cd=1.0 if tails else 0.0)
    wind = torch.ones((3, size, size), dtype=torch.float64) if tails else None
    ry = rx = 0
    oks = []
    for parity in (0, 1):
        slab = torch.full((5, 1, size, size), float("nan"),
                          dtype=torch.float64)
        slab[:, :, pad:pad + n, pad:pad + n] = 1.0
        even = ((torch.arange(size) + parity) % 2 == 0)[:, None]
        ok = torch.isfinite(_chain_on(slab, even, tabs, consts, wind,
                                      sel=_probe_sel)).all(0)[0]
        oks.append(ok)
        # the stagger makes the finite region's edge jagged: take each
        # side's deepest reach along the slab's middle band
        mid = slice(pad + n // 3, pad + 2 * n // 3)
        bad_rows = (~ok[:, mid]).any(1)[pad:pad + n]   # rows with a NaN
        bad_cols = (~ok[mid, :]).any(0)[pad:pad + n]
        for bad in (bad_rows, bad_cols):
            if bool(bad[n // 3:2 * n // 3].any()):
                raise ValueError("the FB chain's radius exceeds the probe")
        top = int(torch.nonzero(~bad_rows)[0])
        bottom = n - 1 - int(torch.nonzero(~bad_rows)[-1])
        left = int(torch.nonzero(~bad_cols)[0])
        right = n - 1 - int(torch.nonzero(~bad_cols)[-1])
        ry, rx = max(ry, top, bottom), max(rx, left, right)
    for parity_ok in oks:
        if not bool(parity_ok[pad + ry:pad + n - ry,
                              pad + rx:pad + n - rx].all()):
            raise ValueError("the FB chain's finite region is not the "
                             "slab minus a ring")
    _RADIUS_CACHE[key] = (ry, rx)
    return ry, rx


def guard_elems(slab_width):
    """Slack (in elements) kept before the first and after the last slab
    array, so that a read shifted by up to 2 rows and 2 columns (the most
    `structured._decompose` accepts) stays inside shared memory."""
    return 2 * slab_width + 2


def plan_tile(ny, nx, itemsize, ring, tile=None):
    """Pick the kernel's tile: dict(by, bx, ry, rx, threads, guard, smem).

    The slab (by+2ry) x (bx+2rx) times SLOTS arrays must fit one block's
    shared memory; the tile need not divide the domain (ragged tiles are
    masked) and is never larger than it. The default is 16 rows x 32
    columns (the fastest of the tiles timed on an H100 at 256 x 256 x 100,
    see PERF.md), halved until it fits. `tile=(by, bx)` or
    `(by, bx, threads)` overrides it."""
    ry, rx = ring

    def smem(by, bx):
        # slab arrays + a guard either side
        slab = (by + 2 * ry) * (bx + 2 * rx)
        return (SLOTS * slab + 2 * guard_elems(bx + 2 * rx)) * itemsize

    threads = None
    if tile is not None:
        by, bx = tile[:2]
        threads = tile[2] if len(tile) > 2 else None
        if by < 1 or bx < 1:
            raise ValueError(f"bad tile {tile}")
        if smem(min(by, ny), min(bx, nx)) > SMEM_LIMIT:
            raise ValueError(f"tile {tile} needs {smem(by, bx)} bytes of "
                             f"shared memory (limit {SMEM_LIMIT})")
    else:
        by, bx = 16, 32
        while smem(min(by, ny), min(bx, nx)) > SMEM_LIMIT:
            if max(by, bx) == 1:
                raise ValueError("no tile fits the shared memory")
            by, bx = max(by // 2, 1), max(bx // 2, 1)
    by, bx = min(by, ny), min(bx, nx)
    if threads is None:
        own = by * bx
        threads = 512 if own >= 1024 else 256 if own >= 256 else 128
    if threads % 32 or not 32 <= threads <= 512:
        raise ValueError(f"bad thread count {threads}")
    return dict(by=by, bx=bx, ry=ry, rx=rx, threads=threads,
                guard=guard_elems(bx + 2 * rx), smem=smem(by, bx))


# ----------------------------------------------------------------------
# layout

def stack_state(mesh, state):
    """ModelState -> the kernel's stacked (1+3+L, K, ny, nx) layout."""
    nx, ny = mesh.structured_nx, mesh.structured_ny
    h, u, tr = state
    K, L = h.shape[-1], tr.shape[0]
    out = torch.empty((4 + L, K, ny, nx), dtype=h.dtype, device=h.device)
    out[0] = h.reshape(ny, nx, K).permute(2, 0, 1)
    out[1:4] = u.reshape(3, ny, nx, K).permute(0, 3, 1, 2)
    out[4:] = tr.reshape(L, ny, nx, K).permute(0, 3, 1, 2)
    return out


def unstack_state(mesh, stacked, K, L, state_type):
    nx, ny = mesh.structured_nx, mesh.structured_ny
    s = stacked.permute(0, 2, 3, 1)                  # (CH, ny, nx, K)
    return state_type(
        h=s[0].reshape(ny * nx, K),
        u=s[1:4].reshape(3 * ny * nx, K),
        tracers=s[4:].reshape(L, ny * nx, K))


# ----------------------------------------------------------------------
# the plain version

def _h_fluxes(h, u, c, ap, sel):
    """(mean_h, flux_h) per edge class: center (flux == mean) or upwind."""
    if c["uph"]:
        h0, h1 = ap("c0", [h], 3), ap("c1", [h], 3)
        return ([0.5 * (h0[i] + h1[i]) for i in range(3)],
                [sel(u[i], h0[i], h1[i]) for i in range(3)])
    mean_h = ap("cmean", [h], 3)
    return mean_h, mean_h


def _fb_chain(h, u, tr, even, tabs, c, wind=None, sel=auxmod._upwind):
    """The FB step chain on grids (K, Y, X). h: tensor; u, tr: lists;
    wind: None or the (3, Y, X) edge-normal stress. Returns (h_new, un,
    trn). Mirrors the kernel level for level."""
    ap = lambda name, vals, pd: apply_grid(tabs[name], vals, even, pd)
    dt, inv_dc, inv_dv = c["dt"], c["inv_dc"], c["inv_dv"]

    # --- thickness (center or upwind flux)
    mean_h, flux_h = _h_fluxes(h, u, c, ap, sel)
    dh = ap("div", [flux_h[i] * u[i] for i in range(3)], 1)[0]
    h_new = h + dt * (-dh)

    # --- tracers (center or upwind flux + del2 + del4)
    trn = []
    for trl in tr:
        if c["upt"]:
            h0, h1 = ap("c0", [h], 3), ap("c1", [h], 3)
            t0, t1 = ap("c0", [trl], 3), ap("c1", [trl], 3)
            htr = [sel(u[i], h0[i] * t0[i], h1[i] * t1[i]) for i in range(3)]
        else:
            htr = ap("cmean", [h * trl], 3)
        adv = -ap("div", [htr[i] * u[i] for i in range(3)], 1)[0]
        ctr = ap("cdiff", [trl], 3)
        d2tr = ap("signed_div",
                  [c["geo"] * mean_h[i] * ctr[i] for i in range(3)], 1)[0]
        cd2 = ap("cdiff", [d2tr], 3)
        hyp = ap("signed_div", [c["geo4"] * cd2[i] for i in range(3)], 1)[0]
        dtr = adv + c["ed2s"] * d2tr - c["ed4"] * hyp
        trn.append((trl * h + dt * dtr) / h_new)

    # --- velocity aux (momentum aux on h_new, FB order)
    ke = ap("ke", [ui * ui for ui in u], 1)[0]
    div_u = ap("div", u, 1)[0]
    rvort = ap("curl", u, 2)
    h_v = ap("kite", [h_new], 2)
    nrv = [rvort[i] / h_v[i] for i in range(2)]
    npv = [c["f0v"] / h_v[i] for i in range(2)]
    nrv_e = ap("vmean", nrv, 3)
    npv_e = ap("vmean", npv, 3)
    q_e = [nrv_e[i] + npv_e[i] for i in range(3)]

    cdd = ap("cdiff", [div_u], 3)
    vdr = ap("vdiff", rvort, 3)
    del2_e = [cdd[i] * inv_dc - vdr[i] * c["inv_dv_floor"] for i in range(3)]
    del2_div = ap("div", del2_e, 1)[0]
    del2_rv = ap("curl", del2_e, 2)

    mean_hn, flux_hn = _h_fluxes(h_new, u, c, ap, sel)
    F = [flux_hn[i] * u[i] for i in range(3)]
    tf = ap("tang", F, 3)
    tfq = ap("tang", [F[i] * q_e[i] for i in range(3)], 3)
    pv = [0.5 * (q_e[i] * tf[i] + tfq[i]) for i in range(3)]

    gke = ap("cdiff", [ke], 3)
    gssh = ap("cdiff", [h_new], 3)       # stacked ssh, uniform depth
    cd4 = ap("cdiff", [del2_div], 3)
    vd4 = ap("vdiff", del2_rv, 3)

    # wind on the top layer, drag on the bottom one, both with mean_h of
    # h_new; 2*cmean(ke) == ke0 + ke1 of the composed step bit for bit
    kee = ap("cmean", [ke], 3) if c["cd"] else None

    # the du diff terms use plain 1/dv (TendencyTerms), while
    # del2_e above used the dv >= 0.25 dc floor (Del2AuxVars)
    un = []
    for i in range(3):
        du = (pv[i]
              - gke[i] * inv_dc
              - c["grav"] * gssh[i] * inv_dc
              + c["nu2s"] * (cdd[i] * inv_dc - vdr[i] * inv_dv)
              - c["nu4s"] * (c["div_factor"] * cd4[i] * inv_dc
                             - vd4[i] * inv_dv))
        if wind is not None:
            du[0] += wind[i] / (c["rho0"] * mean_hn[i][0])
        if c["cd"]:
            speed = torch.sqrt(torch.clamp(2.0 * kee[i][-1], min=0.0))
            du[-1] += -(c["cd"] * speed * u[i][-1] / mean_hn[i][-1])
        un.append(u[i] + dt * du)
    return h_new, un, trn


def _chain_on(s, even, tabs, consts, wind=None, sel=auxmod._upwind):
    """Run the chain on a stacked (4+L, K, Y, X) array; returns the same."""
    h_new, un, trn = _fb_chain(s[0], [s[1], s[2], s[3]],
                               [s[c] for c in range(4, s.shape[0])],
                               even, tabs, consts, wind, sel)
    return torch.stack([h_new] + un + trn)


def fb_megastep_plain(mesh, cfg, stacked, dt, tile=None, ring=None,
                      wind=None):
    """The plain PyTorch version of the fused kernel: the horizontal chain
    of one FB step on the stacked (4+L, K, ny, nx) layout (vertical mixing
    is vmix_kernel.vmix_plain). `wind` is None or the (3, ny, nx) stress
    plane of `stack_wind`.

    tile=None evaluates the chain with periodic rolls on the whole grid.
    tile=(by, bx) evaluates it as the kernel does: for every tile the
    slab with its (ry, rx) ring is cut with wrapped indices, the chain
    runs on the slab with shifts that wrap inside it, and the owned
    centre is pasted. `ring` defaults to `chain_radius`."""
    tabs, consts = _mega_args(mesh, cfg, dt)
    nx, ny = mesh.structured_nx, mesh.structured_ny
    dev = stacked.device
    if tile is None:
        even = (torch.arange(ny, device=dev) % 2 == 0)[:, None]
        return _chain_on(stacked, even, tabs, consts, wind)
    by, bx = tile
    ry, rx = _ring(tabs, consts, wind) if ring is None else ring
    out = torch.empty_like(stacked)
    for y0 in range(0, ny, by):
        for x0 in range(0, nx, bx):
            rows = torch.arange(y0 - ry, y0 + by + ry, device=dev)
            cols = torch.arange(x0 - rx, x0 + bx + rx, device=dev)
            slab = stacked[:, :, rows % ny][:, :, :, cols % nx]
            wslab = None if wind is None else \
                wind[:, rows % ny][:, :, cols % nx]
            even = (rows % 2 == 0)[:, None]
            res = _chain_on(slab, even, tabs, consts, wslab)
            oy, ox = min(by, ny - y0), min(bx, nx - x0)   # ragged edge
            out[:, :, y0:y0 + oy, x0:x0 + ox] = \
                res[:, :, ry:ry + oy, rx:rx + ox]
    return out


def _ring(tabs, consts, wind):
    """chain_radius of the variant these constants and this wind select."""
    return chain_radius(tabs, consts["uph"], consts["upt"],
                        wind is not None or consts["cd"] != 0.0)


def stack_wind(mesh, cfg, wind_stress, dtype):
    """The wind plane the fused step reads: (zonal, merid) cell stresses
    rotated onto the edge normals (aux.wind_normal_stress) and laid out
    like u's classes, (3, ny, nx). None without wind forcing or without a
    stress. `run_steps` packs it once per segment; a caller that steps one
    step at a time on the stacked layout packs it once and passes it on."""
    if wind_stress is None or not cfg.tendencies.wind_forcing:
        return None
    stress = auxmod.wind_normal_stress(mesh, cfg, wind_stress[0],
                                       wind_stress[1])
    return stress.to(dtype).reshape(
        3, mesh.structured_ny, mesh.structured_nx).contiguous()


# ----------------------------------------------------------------------
# the kernel's wrapper

def _params_dtype(ft) -> np.dtype:
    """numpy mirror of `omega::FbParams<T>` (csrc/fb_step.cuh)."""
    ints = ["L", "K", "ny", "nx", "by", "bx", "ry", "rx", "guard"]
    return np.dtype([("off", "i4", (2, MAX_ENTRIES)),
                     ("w", ft, (MAX_ENTRIES,)),
                     ("start", "i2", (len(TABLE_NAMES), 4))]
                    + [(n, ft) for n in CONST_FIELDS]
                    + [(n, "i4") for n in ints], align=True)


def pack_params(tabs, consts, ft, plan):
    """The tables, constants and tile plan as one FbParams record.

    Entries are laid out table by table (TABLE_NAMES order), class by
    class, in table order within a class — the layout the kernel has at
    compile time. Each entry becomes a flat offset into the slab arrays
    per row parity, class * S + dj * XX + di, for the plan's slab."""
    rec = np.zeros((), _params_dtype(ft))
    YY, XX = plan["by"] + 2 * plan["ry"], plan["bx"] + 2 * plan["rx"]
    S = YY * XX
    n = 0
    for b, name in enumerate(TABLE_NAMES):
        pd = _PD[name]
        ent, start = pack_entries(tabs[name], pd, ft)
        if n + len(ent) > MAX_ENTRIES:
            raise ValueError("the FB chain's tables exceed the kernel's "
                             f"{MAX_ENTRIES} entries")
        sl = slice(n, n + len(ent))
        base = ent["ts"].astype(np.int64) * S + ent["dj"].astype(np.int64) * XX
        rec["off"][0, sl] = base + ent["di_e"]
        rec["off"][1, sl] = base + ent["di_o"]
        rec["w"][sl] = ent["w"]
        rec["start"][b, :pd + 1] = n + start
        rec["start"][b, pd + 1:] = n + start[-1]
        n += len(ent)
    if np.abs(rec["off"]).max() > plan["guard"] + 2 * S:
        raise ValueError("a table shift exceeds the slab guard")
    for k in CONST_FIELDS:
        rec[k] = consts[k]
    for k in ("by", "bx", "ry", "rx", "guard"):
        rec[k] = plan[k]
    return rec


_PARAM_CACHE: dict = {}


def fb_megastep_stacked(mesh, cfg, stacked, dt, out=None, tile=None,
                        wind=None):
    """One FB step on the stacked layout (stacked -> stacked), out of
    place: on PyTorch's current stream for a CUDA array, one launch of the
    horizontal kernel, then, with vertical mixing, the column kernels in
    place on the result (vmix_kernel.vmix_stacked); the plain versions
    for a CPU array. `out`, when given, is a distinct array of the same
    shape that receives the result; `wind` is None or the (3, ny, nx)
    plane of `stack_wind`."""
    global launches
    mix = vmix_kernel.vmix_on(cfg)
    if not stacked.is_cuda:
        res = fb_megastep_plain(mesh, cfg, stacked, dt, wind=wind)
        if mix:
            res = vmix_kernel.vmix_plain(mesh, cfg, res, dt)
        if out is None:
            return res
        out.copy_(res)
        return out
    if stacked.dtype not in _FLOAT:
        raise TypeError(f"fused FB kernel takes float32/float64, "
                        f"got {stacked.dtype}")
    nx, ny = mesh.structured_nx, mesh.structured_ny
    if stacked.ndim != 4 or stacked.shape[0] < 4 \
            or tuple(stacked.shape[2:]) != (ny, nx):
        raise ValueError(f"stacked state must be (4+L, K, {ny}, {nx}), "
                         f"got {tuple(stacked.shape)}")
    if not stacked.is_contiguous():
        raise ValueError("stacked state must be contiguous")
    if out is None:
        out = torch.empty_like(stacked)
    elif (out.shape != stacked.shape or out.dtype != stacked.dtype
          or out.device != stacked.device or not out.is_contiguous()):
        raise ValueError("`out` must match the stacked state and be "
                         "contiguous")
    elif out.data_ptr() == stacked.data_ptr():
        raise ValueError("the fused FB step is out of place: `out` must "
                         "not alias the input")
    if wind is not None and (
            tuple(wind.shape) != (3, ny, nx) or wind.dtype != stacked.dtype
            or wind.device != stacked.device or not wind.is_contiguous()):
        raise ValueError(f"the wind plane must be a contiguous (3, {ny}, "
                         f"{nx}) array of the state's type and device")
    ft, suffix = _FLOAT[stacked.dtype]
    L, K = stacked.shape[0] - 4, stacked.shape[1]

    key = (nx, ny, mesh.structured_dc, mesh.structured_scalars, cfg,
           float(dt), suffix, L, K, tile, wind is not None)
    hit = _PARAM_CACHE.get(key)
    if hit is None:
        tabs, consts = _mega_args(mesh, cfg, dt)
        plan = plan_tile(ny, nx, np.dtype(ft).itemsize,
                         _ring(tabs, consts, wind), tile)
        rec = pack_params(tabs, consts, ft, plan)
        rec["L"], rec["K"], rec["ny"], rec["nx"] = L, K, ny, nx
        # the compiled variant: flux types, and the tails only when wanted
        name = "omega_fb_step_{}{}_{}_{}".format(
            "u" if consts["uph"] else "c", "u" if consts["upt"] else "c",
            "tails" if wind is not None or consts["cd"] != 0.0 else "plain",
            suffix)
        hit = _PARAM_CACHE[key] = (rec, plan["threads"], name)
    rec, threads, name = hit

    lib = _build.load()
    size = getattr(lib, f"omega_fb_params_size_{suffix}")()
    if size != rec.dtype.itemsize or lib.omega_fb_slots() != SLOTS:
        raise RuntimeError(f"FbParams layout mismatch: kernel {size} bytes, "
                           f"host {rec.dtype.itemsize}")
    with torch.cuda.device(stacked.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, name)(
            stacked.data_ptr(), out.data_ptr(),
            None if wind is None else wind.data_ptr(), rec.ctypes.data,
            threads, stream)
    _build.check(code, "fused FB step launch")
    launches += 1
    if mix:
        vmix_kernel.vmix_stacked(mesh, cfg, out, dt)
    return out


def fb_megastep(mesh, cfg, state, t, dt, wind_stress=None):
    """One forward-backward step (== stepping.forward_backward_step) for
    a supported configuration."""
    h, _, tr = state
    out = fb_megastep_stacked(
        mesh, cfg, stack_state(mesh, state), dt,
        wind=stack_wind(mesh, cfg, wind_stress, h.dtype))
    return unstack_state(mesh, out, h.shape[-1], tr.shape[0], type(state))
