#!/usr/bin/env python3
"""Least times of the TPU kernels' work on one NVIDIA H100, from shapes.

    python3 port_bounds.py

Prints one JSON line per TPU kernel (`pl.pallas_call` site) whose bound
PERF.md states without a chip run: the bytes the function must move (each
input read once, each output written once) at 3.35 TB/s and its operations
at 67 TFLOP/s (float32 outside the tensor cores), the larger of the two
being the bound. Float32 throughout, K = 100 layers, 2 tracers.

  patch   omega_tpu/ops/patch_megastep.py:1425, one FB step of the flagship
          chain on the icosahedral sphere at bench.py's icos96 mode
          (subdivision 96): the state read and written once, plus the
          mesh's per-element weights of the chain's stencils read once
  patch_science  the same site at icos48, one FB step of the Omega-1
          science configuration (upwind fluxes, wind, bottom drag, PP81
          vertical mixing): the flagship's bytes plus the wind stress on the
          edges read once and the PP81 coefficient fields (kappa at the
          cells, nu at the edges, K-1 interfaces) counted once; and its
          three kernels of the port one by one ("horizontal": the patch
          step's science variant; "coeffs": the PP81 coefficient pass;
          "solve": the column solves), each input read once and each output
          written once; and "coeffs_frames", the coefficient pass over the
          port's frames (10 x S x S positions, S = n + 16: h, 3 u, T and
          S read and kappa and 3 nu written at every position, the 1.78x
          as many positions as the mesh has cells at icos48)
  patch_fct  the same site at icos48, kinds fcta / fctb (patch_megastep.py
          :1797): one FB step with Zalesak FCT tracer fluxes (flagship
          terms, center thickness flux). Stage A reads the state and the
          flagship's weights and writes h_new, u_new and per tracer the
          provisional field and the numerator (4 + 2L fields); stage B
          reads the state, h_new, the provisional fields and the
          numerators and the divergence weights (its relu'd halves are
          the same numbers; the neighbour picks carry no weights) and
          writes the tracers; the step reads the state and the weights and
          writes the state, as `patch`. Operations: the flagship chain's
          for stage A; for stage B per tracer the flux pair, four budget
          walks, the corrected flux's divergence, 26 min / max of the
          bounds and the pointwise limiter. Also the TPU kernels' own I/O
          (frames of 10 x SS x SS x 128 lanes with SS = S + 16, S = n + 16,
          outputs S x S; their weight-plane stack not counted)
  patch_rk  the same site at icos48, kinds rk2a / rk2b / rk4s1-rk4s4
          (patch_megastep.py:1711, :2005): one RK stage of the flagship
          chain, each input read once and each output written once, the
          weights read once per stage. rk2a reads the state and writes the
          midpoint; rk2b reads the midpoint and the original state and
          writes the state; rk4s1 reads the state and writes the
          provisional state and the accumulator; rk4s2 / rk4s3 read the
          provisional state, the original state and the accumulator and
          write the provisional state and the accumulator; rk4s4 reads the
          provisional state and the accumulator and writes the state. Each
          stage's operations are the FB chain's. Also one RK2 and one RK4
          step (the sums of their stages) and, for RK2, the same step with
          the science configuration's wind rows read by both stages and its
          coefficient and solve kernels after the last stage
          (patch_science's parts); and each kind's five passes as functions
          of their own (patch_rk_passes: the intermediates each pass reads
          and writes once, and its weights)
  patch_fb_passes  the FB step's six passes on the sphere (the patch
          step, kind fb) as functions of their own, as patch_rk_passes
  patch_split  the same site at icos48, kinds splitpre / splitpost
          (patch_megastep.py:2131): splitpre reads h, u and the tracers and
          the momentum chain's weights and writes du_out (the three edge
          classes); splitpost reads h, the transport velocity and the
          tracers and the thickness and tracer weights and writes h_new and
          the tracers; operations the FB chain's momentum part and its
          thickness and tracer parts
  sphere_bt  the split step's barotropic subcycles on the icosahedral
          sphere at icos48 (the reference's `lax.scan` at
          omega_tpu/ops/patch_megastep.py:2205-2226, not a Pallas site; the
          port's csrc/bt_gather.cu): one subcycle reads ub, ssh, g_slow,
          het and the accumulator, writes ub, ssh and the accumulator, and
          reads the gradient's cells and 1/dc, the tangential
          reconstruction's edges and weights, the divergence's edges and
          weights, f and the edge mask, once each; M = 10 subcycles as one
          function read its inputs (ubar, ssh, g_slow, het, the mesh's
          arrays) once and write ub, ssh and <ubar> once, and also as M
          subcycles each from device memory. Operations: two per gather
          entry, about ten more per edge and two per cell
  gather  omega_tpu/ops/pallas_gather.py:160, one gather pass
          out[l, n] = sum_j w[n, j] field[l, idx[n, j]] at icos48 x 100
          (the shape named at pallas_gather.py:94-96), for each of the 16
          tables of trisk.warm_gather, with L = 1 and 2 leading indices:
          the field read and the output written once per leading index,
          the table read once as CSR (each nonzero entry an int32 column
          and a float32 weight, n + 1 int32 row offsets; the CSR bytes are
          printed). Entries: every slot of a valid neighbour (the sphere
          has no land); chip_smoke.py counts the nonzero weights of the
          run's own tables instead (the tangential table holds a few exact
          zeros). Also one FB step's gather calls (FB_STEP_GATHERS: the
          composed step's calls by table and leading count, held against
          the port's step by tests/test_torch_gather.py) summed
  composed_planar  omega_tpu/ops/pallas_stencil_dma.py:153, the composed
          planar FB step's 27 structured stencil passes at 256 x 256 x 100
          (FB_STEP_GATHERS: the same calls by table and leading count),
          each pass's input read and output written once; with column ssh
          (chip_smoke.py's composed_path) the ssh gradient is one pass on
          a single plane
  composed_planar_passes  the same 27 passes one by one, in the order
          the composed planar FB step with column ssh runs them
          (COMPOSED_FB_PASSES: table, leading indices, layers), each a
          function of its own (its input read and its output written once)
          and their sum, for pass_times.py's per-pass table
  split   the TPU split kernels' own I/O (megastep.py:1136 kinds splitpre /
          splitpost; barotropic_kernel.py:97) at 256 x 256, for comparison
          with the port's (chip_smoke.py computes the port's bounds)
  split_pre_passes  the planar splitpre's passes at 256 x 256 x 100 as
          functions of their own (this design's column pass and chain, and
          the earlier design's three passes), each input read once and
          each output written once (chip_smoke.py computes the whole
          call's bound)
  split_post_pass  the planar splitpost at 256 x 256 x 100, one launch, as
          a function of its own (chip_smoke.py's splitpost bound)
  patch_fct_b_passes  FCT's stage B on the sphere at icos48 as its four
          passes (flux, ratios, limit, tracers), each a function of its
          own, and the scratch bytes they move through device memory

Element counts of the icosahedral mesh of subdivision n: 10 n^2 + 2 cells
(12 pentagons), 30 n^2 edges, 20 n^2 vertices; a cell has as many edges as
sides, a vertex 3 edges, an edge's tangential stencil the other edges of its
two cells. Operations: two per stencil entry applied, plus the pointwise
arithmetic, counted per (cell, layer) as for the planar hex chain
(chip_smoke.py:_fb_flops_per_point with the hex mesh's entry counts).
"""

import json

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS_F32 = 67e12
F32 = 4
IDX = 4
K, L = 100, 2


def bound(nbytes, flops):
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    to = flops / PEAK_FLOPS_F32 * 1e3
    return {"bytes": nbytes, "flops": flops, "bytes_ms": tb, "ops_ms": to,
            "bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations"}


def icos(n):
    C, E, V = 10 * n * n + 2, 30 * n * n, 20 * n * n
    # entries: cell-edge pairs (2 per edge), vertex-edge pairs (3 per
    # vertex), tangential pairs (per cell, sides * (sides - 1))
    cell_edge = 2 * E
    vert_edge = 3 * V
    tang = 30 * (C - 12) + 20 * 12
    return C, E, V, cell_edge, vert_edge, tang


def hex_flops_parts():
    """The parts of _fb_flops_per_point of chip_smoke.py with the hex
    mesh's entries per table and destination class (per cell: 3 edges, 2
    vertices): (thickness, one tracer, momentum) per (cell, layer)."""
    n = {"div": 6, "ke": 6, "curl": 6, "kite": 6, "tang": 24, "cdiff": 6,
         "cmean": 6, "vdiff": 6, "vmean": 6, "signed_div": 6}
    s = lambda *names: sum(n[k] for k in names)
    thick = 2 * s("cmean", "div") + 5
    tracer = 2 * s("cmean", "div", "cdiff", "signed_div", "cdiff",
                   "signed_div") + 24
    vel = 2 * s("ke", "div", "curl", "kite", "vmean", "vmean", "cdiff",
                "vdiff", "div", "curl", "cmean", "tang", "tang", "cdiff",
                "cdiff", "cdiff", "vdiff") + 90
    return thick, tracer, vel


def hex_flops_per_cell_layer(ntracers):
    thick, tracer, vel = hex_flops_parts()
    return thick + ntracers * tracer + vel


def patch_fb(n=96):
    C, E, V, ce, ve, tang = icos(n)
    state = (C * (1 + L) + E) * K * F32          # h, tracers, u
    # per-element weights the chain's stencils need (a uniform weight is a
    # scalar): div, ke and the signed (diffusion) divergence on cell-edge
    # pairs; curl and kite areas on vertex-edge pairs; the tangential
    # weights; 1/dc and 1/dv per edge; f per vertex
    weights = (3 * ce + 2 * ve + tang + 2 * E + V) * F32
    flops = hex_flops_per_cell_layer(L) * C * K
    return {"kernel": "omega_tpu/ops/patch_megastep.py:1425",
            "function": f"one FB step, icos{n} x {K} layers x {L} tracers",
            "cells": C, "edges": E, "vertices": V,
            "state_bytes_in_out": 2 * state, "weight_bytes": weights,
            **bound(2 * state + weights, flops)}


def patch_science(n=48):
    C, E, V, ce, ve, tang = icos(n)
    fb = patch_fb(n)
    KI = K - 1
    wind = E * F32
    coef = (C + E) * KI * F32
    levels = (K - 1).bit_length()                 # ceil(log2 K)
    frames = 10 * (n + 16) ** 2                   # frame positions
    # the horizontal step: the flagship's work and the wind rows; the
    # coefficients: h_new, u_new, T, S read, kappa and nu written, ~90
    # operations per cell and interface (chip_smoke.py's planar count);
    # the solve: h_new, u, the tracers and the coefficients read, u and
    # the tracers written, per level and row 16 operations for a matrix
    # and 4 per right-hand side (one system per cell with L, one per edge)
    parts = {
        "horizontal": bound(fb["bytes"] + wind, fb["flops"]),
        "coeffs": bound(((3 * C + E) * K + coef // F32) * F32,
                        90 * KI * C),
        "solve": bound((C * (1 + 2 * L) + 2 * E) * K * F32 + coef,
                       levels * K * (C * (16 + 4 * L) + E * (16 + 4))),
        "coeffs_frames": bound((6 * K + 4 * KI) * frames * F32,
                               90 * KI * frames)}
    return {"kernel": "omega_tpu/ops/patch_megastep.py:1425",
            "function": f"one FB step of the science configuration, icos{n}"
            f" x {K} layers x {L} tracers",
            "wind_bytes": wind, "coefficient_bytes": coef,
            **bound(fb["bytes"] + wind + coef,
                    fb["flops"] + parts["coeffs"]["flops"]
                    + parts["solve"]["flops"]),
            "parts": parts}


def patch_fct(n=48):
    C, E, V, ce, ve, tang = icos(n)
    fb = patch_fb(n)
    state = (C * (1 + L) + E) * K
    mid = C * (1 + 2 * L) * K                     # h_new, trtd, facc
    # stage A reads h, u, tr and writes h_new, u_new, trtd, facc
    a_bytes = (2 * state + C * L * K) * F32 + fb["weight_bytes"]
    b_bytes = (state + mid + C * L * K) * F32 + ce * F32
    # per (cell, layer) of one tracer in stage B: flux pair (2 picks, the
    # mean and the upwind pick, two products, a difference), the four
    # budget walks and the corrected flux's divergence over 6 edges, the
    # 26 min / max, the pointwise limiter (~24) and the update (4)
    per_tracer_b = 3 * 8 + 2 * 5 * 6 + 26 + 24 + 4
    b_flops = L * per_tracer_b * C * K
    S = n + 16
    SS = S + 16
    chan_in = 10 * SS * SS * 128 * F32
    chan_out = 10 * S * S * 128 * F32
    return {"kernel": "omega_tpu/ops/patch_megastep.py:1425",
            "function": f"one FB step with FCT tracer fluxes, icos{n} x {K} "
            f"layers x {L} tracers",
            **bound(fb["bytes"], fb["flops"] + b_flops),
            "stage_a": bound(a_bytes, fb["flops"]),
            "stage_b": bound(b_bytes, b_flops),
            "tpu_fcta_io": {"reads": f"{4 + L} frame channels",
                            "writes": f"{4 + 2 * L} channels",
                            **bound((4 + L) * chan_in + (4 + 2 * L) * chan_out,
                                    0)},
            "tpu_fctb_io": {"reads": f"{5 + 3 * L} frame channels",
                            "writes": f"{L} channels",
                            **bound((5 + 3 * L) * chan_in + L * chan_out, 0)}}


def patch_fct_b_passes(n=48):
    """FCT's stage B on the sphere at icos{n} as its four passes, each a
    function of its own (each input read once, each output written once;
    the fluxes on the mesh's edges, the ratios on its cells): flux reads h,
    u, the tracers and the cmean weights and writes the antidiffusive and
    the low-order flux; ratios reads the antidiffusive flux, the tracers,
    trtd, h_new and the divergence weights and writes r_in and r_out; limit
    reads both fluxes, r_in and r_out and writes the corrected flux;
    tracers reads it, facc, h_new and the divergence weights and writes the
    tracers. Operations per (edge or cell, layer) of one tracer: the flux
    pair 8 per edge, the four budget walks, the 26 min / max and the ratios
    (12) per cell, the picks and the limiter 8 per edge, the divergence and
    the update per cell. Also the scratch the passes move through device
    memory on the frames (P = 10 S^2, S = n + 16): pass 1 writes the two
    fluxes (3L fields each), pass 2 reads the first and writes r_in and
    r_out (L each), pass 3 reads all four and writes the corrected flux
    over the low-order one, pass 4 reads it."""
    C, E, V, ce, ve, tang = icos(n)
    cells, edges = C * L * K, E * L * K          # one value per tracer
    S = n + 16
    fields = 10 * S * S * K * F32                 # one (K, P) field
    scratch = (2 * 3 * L + 3 * L + 2 * L + 2 * L + 3 * 3 * L + 3 * L) \
        * fields
    return {"flux": bound(((C + E) * K + cells + 2 * edges) * F32
                          + ce * F32, 8 * edges),
            "ratios": bound((edges + 2 * cells + C * K + 2 * cells) * F32
                            + ce * F32, (2 * 4 * 6 + 26 + 12) * cells),
            "limit": bound((3 * edges + 2 * cells) * F32, 8 * edges),
            "tracers": bound((edges + cells + C * K + cells) * F32
                             + ce * F32, (2 * 6 + 4) * cells),
            "scratch_bytes": scratch}


def patch_rk(n=48):
    fb = patch_fb(n)
    sci = patch_science(n)
    state = fb["state_bytes_in_out"] // 2
    # stage -> (state volumes read, state volumes written)
    io = {"rk2a": (1, 1), "rk2b": (2, 1), "rk4s1": (1, 2), "rk4s2": (3, 2),
          "rk4s3": (3, 2), "rk4s4": (2, 1)}
    stages = {k: bound((r + w) * state + fb["weight_bytes"], fb["flops"])
              for k, (r, w) in io.items()}
    passes = {k: patch_rk_passes(n, r - 1 if k in ("rk2b", "rk4s2", "rk4s3",
                                                   "rk4s4") else r, w)
              for k, (r, w) in io.items()}

    def total(kinds, extra=()):
        parts = [stages[k] for k in kinds] + list(extra)
        return bound(sum(x["bytes"] for x in parts),
                     sum(x["flops"] for x in parts))
    return {"kernel": "omega_tpu/ops/patch_megastep.py:1425",
            "function": f"one RK stage of the flagship chain, icos{n} x {K} "
            f"layers x {L} tracers",
            "state_bytes": state, "weight_bytes": fb["weight_bytes"],
            "stages": stages, "passes": passes,
            "rk2_step": total(("rk2a", "rk2b")),
            "rk4_step": total(("rk4s1", "rk4s2", "rk4s3", "rk4s4")),
            "rk2_step_science": total(
                ("rk2a", "rk2b"), (sci["parts"]["coeffs"],
                                   sci["parts"]["solve"],
                                   bound(2 * sci["wind_bytes"], 0)))}


def patch_rk_passes(n=48, base_reads=1, writes=1):
    """Each pass of the port's RK stage (csrc/patch_rk.cuh: A, B, C, D1 the
    cells' update, D2 the edges') as a function of its own: the fields it
    reads and writes, each once, and the per-element weights it applies
    (patch_fb's model: div, ke and the signed divergence on cell-edge
    pairs, curl and kite areas on vertex-edge pairs, the tangential
    weights, 1/dc and 1/dv, f; a uniform weight is a scalar). D1 and D2
    also read `base_reads` state volumes (the base and the accumulator the
    mode takes; the level is pass A's) and write `writes` (out and the
    accumulator). Operations: two per stencil entry applied per layer."""
    C, E, V, ce, ve, tang = icos(n)
    # field reads and writes in (element, layer) units
    io = {"A": ((C * (1 + L) + E), (E * (1 + 2 * L) + 2 * C + 2 * V)),
          "B": (E * (1 + 2 * L) + 3 * C + 2 * V, C * (1 + 2 * L) + 3 * E),
          "C": (C * L + E, E * L + V + C),
          "D1": (C * (1 + L) + E * L + base_reads * C * (1 + L),
                 writes * C * (1 + L)),
          "D2": (2 * V + C + 3 * E + base_reads * E, writes * E)}
    weights = {"A": 2 * ce + E + 2 * ve + V, "B": 2 * ce + 2 * E,
               "C": E + ve + ce, "D1": ce, "D2": 2 * E + tang}
    entries = {"A": 2 * E * (1 + 2 * L) + 2 * ce + 2 * ve,
               "B": ce * (1 + 3 * L) + 4 * 2 * E + 2 * E * 2,
               "C": 2 * E * L + ve + ce, "D1": ce * L,
               "D2": 2 * E * 3 + 2 * tang}
    return {k: bound((r + w) * K * F32 + weights[k] * F32,
                     2 * entries[k] * K)
            for k, (r, w) in io.items()}


def patch_fb_passes(n=48):
    """Each pass of the port's FB patch step (csrc/patch_step.cuh: A, B, C,
    D1 the cells' tracers, D2 the edges' du, E the new u), flagship chain,
    as a function of its own: the fields it reads and writes, each once,
    and the per-element weights it applies (patch_rk_passes' model).
    A reads the state and writes flux, hflux and mc per tracer, ke, div u
    and curl u; B reads those and h and writes h_new, trp and d2aux per
    tracer, dup and del2e; C reads d2aux, h_new, u, curl u and del2e and
    writes cd2 per tracer, F, qv, dr2 and dd2; D1 reads h, h_new, trp, cd2
    and the tracers and writes the tracers; D2 reads qv, F, dd2, dr2,
    h_new and dup and writes Fq and dup; E reads u, dup and Fq and writes
    u. Operations: two per stencil entry applied per layer. Also the six
    passes' sum."""
    C, E, V, ce, ve, tang = icos(n)
    # field reads and writes in (element, layer) units
    io = {"A": (C * (1 + L) + E, E * (1 + 2 * L) + 2 * C + V),
          "B": (E * (1 + 2 * L) + 3 * C + V, C * (1 + 2 * L) + 2 * E),
          "C": (C * (1 + L) + 2 * E + V, E * (1 + L) + 2 * V + C),
          "D1": (C * (2 + 2 * L) + E * L, C * L),
          "D2": (2 * V + 2 * C + 2 * E, 2 * E),
          "E": (3 * E, E)}
    weights = {"A": 2 * ce + E + ve, "B": 2 * ce + 2 * E,
               "C": E + 2 * ve + ce + V, "D1": ce, "D2": 2 * E + tang,
               "E": tang}
    entries = {"A": 2 * E * (1 + 2 * L) + 2 * ce + ve,
               "B": ce * (1 + 3 * L) + 4 * 2 * E,
               "C": 2 * E * (1 + L) + 2 * ve + ce, "D1": ce * L,
               "D2": 2 * E * 4 + tang, "E": tang}
    out = {k: bound((r + w) * K * F32 + weights[k] * F32,
                    2 * entries[k] * K)
           for k, (r, w) in io.items()}
    out["sum"] = bound(sum(v["bytes"] for v in out.values()),
                       sum(v["flops"] for v in out.values()))
    return out


def patch_split(n=48):
    C, E, V, ce, ve, tang = icos(n)
    fb = patch_fb(n)
    state = fb["state_bytes_in_out"] // 2
    thick, tracer, vel = hex_flops_parts()
    # weights: the momentum chain's (div, ke; curl, kite; tang; 1/dc, 1/dv;
    # f) and the thickness and tracer chain's (div, signed div; 1/dc)
    w_pre = (2 * ce + 2 * ve + tang + 2 * E + V) * F32
    w_post = (2 * ce + E) * F32
    return {"kernel": "omega_tpu/ops/patch_megastep.py:1425",
            "function": f"split-explicit phases, icos{n} x {K} layers x "
            f"{L} tracers",
            "splitpre": bound(state + E * K * F32 + w_pre, vel * C * K),
            "splitpost": bound(state + C * (1 + L) * K * F32 + w_post,
                               (thick + L * tracer) * C * K)}


def sphere_bt(n=48, M=10):
    C, E, V, ce, ve, tang = icos(n)
    fields_sub = (4 * E + C) + (2 * E + C)       # read, written
    fields_fn = (3 * E + C) + (2 * E + C)        # ubar, ssh, g_slow, het
    mesh = (2 * E * IDX + E * F32) + tang * (IDX + F32) \
        + ce * (IDX + F32) + 2 * E * F32
    flops = 2 * (2 * E + tang + ce) + 10 * E + 2 * C
    sub = bound(fields_sub * F32 + mesh, flops)
    return {"kernel": "omega_tpu/ops/patch_megastep.py:2205 (lax.scan)",
            "function": f"barotropic subcycles, icos{n}, (E, 1) / (C, 1)",
            "cells": C, "edges": E, "subcycle": sub,
            f"M{M}": bound(fields_fn * F32 + mesh, M * flops),
            f"M{M}_each_from_memory": bound(M * sub["bytes"], M * flops)}


# one composed FB step's gather passes on an unstructured mesh with tables
# (ops/trisk.py's table branch): (table, leading indices) -> passes
FB_STEP_GATHERS = {("cdiff", 1): 5, ("cdiff", 2): 3, ("cmean", 1): 2,
                   ("cmean", 2): 1, ("curl", 1): 2, ("div", 1): 3,
                   ("div", 2): 1, ("ke", 1): 1, ("kite", 1): 1,
                   ("signed_div", 2): 3, ("tang", 2): 1, ("vdiff", 1): 3,
                   ("vmean", 2): 1}


def gather_tables(n=48):
    """table -> (rows, source rows, nonzero entries) at icos n."""
    C, E, V, ce, ve, tang = icos(n)
    return {"div": (C, E, ce), "div_pos": (C, E, E), "div_neg": (C, E, E),
            "ke": (C, E, ce), "signed_div": (C, E, ce),
            "curl": (V, E, ve), "kite": (V, C, ve), "tang": (E, E, tang),
            "cdiff": (E, C, 2 * E), "cmean": (E, C, 2 * E),
            "vdiff": (E, V, 2 * E), "vmean": (E, V, 2 * E),
            "c0": (E, C, E), "c1": (E, C, E), "v0": (E, V, E),
            "v1": (E, V, E)}


def gather(n=48):
    out = {}
    for name, (rows, nsrc, entries) in gather_tables(n).items():
        csr = entries * (IDX + F32) + (rows + 1) * IDX
        for lead in (1, 2):
            nbytes = lead * (nsrc + rows) * K * F32 + csr
            out[f"{name}_L{lead}"] = {
                "rows": rows, "source_rows": nsrc, "entries": entries,
                "csr_bytes": csr, **bound(nbytes, 2 * entries * K * lead)}
    step = {q: sum(c * out[f"{t}_L{lead}"][q]
                   for (t, lead), c in FB_STEP_GATHERS.items())
            for q in ("bytes", "flops", "bound_ms")}
    return {"kernel": "omega_tpu/ops/pallas_gather.py:160",
            "function": f"one gather pass, icos{n} x {K} layers", **out,
            "fb_step": {"passes": sum(FB_STEP_GATHERS.values()), **step}}


# classes per lattice cell of a stencil table's source and destination on
# the planar hex mesh (cells 1, edges 3, vertices 2)
HEX_CLASSES = {"div": (3, 1), "ke": (3, 1), "signed_div": (3, 1),
               "curl": (3, 2), "kite": (1, 2), "tang": (3, 3),
               "cdiff": (1, 3), "cmean": (1, 3), "vdiff": (2, 3),
               "vmean": (2, 3)}


def composed_planar(ny=256, nx=256):
    """The composed planar FB step's stencil passes, summed: stacked ssh
    (every pass on K layers) and column ssh (the ssh gradient, one cdiff
    pass, on a single plane)."""
    vol = ny * nx * K * F32
    nbytes = sum(sum(HEX_CLASSES[t]) * lead * n * vol
                 for (t, lead), n in FB_STEP_GATHERS.items())
    column = nbytes - sum(HEX_CLASSES["cdiff"]) * vol * (1 - 1 / K)
    return {"passes": sum(FB_STEP_GATHERS.values()),
            "stacked_ssh": bound(nbytes, 0),
            "column_ssh": bound(int(column), 0)}


# the composed planar FB step's stencil passes with column ssh, in the
# order it runs them: (table, leading indices, layers); the ssh gradient is
# the one cdiff pass on a single plane
COMPOSED_FB_PASSES = (
    ("cmean", 1, K), ("div", 1, K), ("cmean", 2, K), ("cdiff", 2, K),
    ("signed_div", 2, K), ("div", 2, K), ("cdiff", 2, K),
    ("signed_div", 2, K), ("cdiff", 2, K), ("signed_div", 2, K),
    ("curl", 1, K), ("kite", 1, K), ("vmean", 2, K), ("ke", 1, K),
    ("div", 1, K), ("cmean", 1, K), ("cdiff", 1, K), ("vdiff", 1, K),
    ("div", 1, K), ("curl", 1, K), ("tang", 2, K), ("cdiff", 1, K),
    ("cdiff", 1, 1), ("cdiff", 1, K), ("vdiff", 1, K), ("cdiff", 1, K),
    ("vdiff", 1, K))


def composed_planar_passes(ny=256, nx=256):
    """Each pass of COMPOSED_FB_PASSES as a function of its own at ny x nx
    float32: (ps + pd) x leading indices x layers planes moved once."""
    passes = [{"table": t, "lead": lead, "K": k,
               **bound(sum(HEX_CLASSES[t]) * lead * ny * nx * k * F32, 0)}
              for t, lead, k in COMPOSED_FB_PASSES]
    return {"passes": passes,
            "sum": bound(sum(p["bytes"] for p in passes), 0)}


def split_pre_passes(nx=256, ny=256, k=K):
    """The planar splitpre's passes as functions of their own at nx x ny x
    k float32, each input read once and each output written once: this
    design's two (the column pass: h, u in, ubar, sshc, het out; the chain
    with the depth average and the slow forcing: h, u, sshc, ubar, het in,
    du_full, g_slow, du_bar out; its partial sums are its own) and the
    earlier three-pass design's (the column pass; the chain: h, u, sshc in,
    du_full out; the slow pass: h, du_full, sshc, ubar, het in, g_slow,
    du_bar out). Operations:
    the column sums 2 per cmean entry and 3 per edge class and layer; the
    chain the momentum part of the hex chain (hex_flops_parts); the depth
    average 2 per edge class and layer, the slow forcing's stencils 2 per
    entry on one plane."""
    plane = ny * nx * F32
    vol = k * plane
    pts = ny * nx * k
    vel = hex_flops_parts()[2]
    cols = 3 * (2 * 2 + 3) + 1
    avg = 3 * 2
    slow = 3 * 2 * (2 + 8) + 12
    return {"columns": bound(4 * vol + 7 * plane, cols * pts),
            "chain": bound(7 * vol + 13 * plane,
                           (vel + avg) * pts + slow * ny * nx),
            "three_pass": {"columns": bound(4 * vol + 7 * plane, cols * pts),
                    "chain": bound(7 * vol + plane, vel * pts),
                    "slow": bound(4 * vol + 13 * plane,
                                  (avg + 6) * pts + slow * ny * nx)}}


def split_post_pass(nx=256, ny=256, k=K):
    """The planar splitpost at nx x ny x k float32 as a function of its
    own: the state (4 + L volumes), du_full (3 volumes) and 12 planes
    (ubar, du_bar, ub_final, <ubar>) read once, the state written once;
    operations the hex chain's thickness and tracer parts (hex_flops_parts)
    and u_new's five per edge class (chip_smoke.py's
    _split_flops_per_point)."""
    plane = ny * nx * F32
    vol = k * plane
    thick, tracer, _ = hex_flops_parts()
    return bound((2 * (4 + L) + 3) * vol + 12 * plane,
                 (thick + L * tracer + 3 * 5) * ny * nx * k)


def tpu_split_io(ny=256, nx=256):
    plane = ny * nx * F32
    vol = K * plane
    return {"splitpre_tpu_io": {
                "reads": "6 state volumes", "writes": "6 volumes + 10 planes",
                **bound(12 * vol + 10 * plane, 0)},
            "splitpost_tpu_io": {
                "reads": "12 volumes + 6 planes", "writes": "6 volumes",
                **bound(18 * vol + 6 * plane, 0)},
            "barotropic_tpu_io": {
                "reads": "10 planes", "writes": "7 planes",
                **bound(17 * plane, 0)}}


if __name__ == "__main__":
    print(json.dumps({"patch": patch_fb()}))
    print(json.dumps({"patch_science": patch_science()}))
    print(json.dumps({"patch_fct": patch_fct()}))
    print(json.dumps({"patch_fct_b_passes": patch_fct_b_passes()}))
    print(json.dumps({"patch_fb_passes": patch_fb_passes()}))
    print(json.dumps({"patch_rk": patch_rk()}))
    print(json.dumps({"patch_split": patch_split()}))
    print(json.dumps({"sphere_bt": sphere_bt()}))
    print(json.dumps({"gather": gather()}))
    print(json.dumps({"composed_planar": composed_planar()}))
    print(json.dumps({"composed_planar_passes": composed_planar_passes()}))
    print(json.dumps({"split": tpu_split_io()}))
    print(json.dumps({"split_pre_passes": split_pre_passes()}))
    print(json.dumps({"split_post_pass": split_post_pass()}))
