"""Reproducible global reductions, on one array or across a list of shards.

Rewrite of base/Reductions.h: the reference guarantees reproducible R8
global sums across partition counts by accumulating locally in
double-double arithmetic and reducing with a custom ``ddSum`` MPI_Op
(base/Reductions.h:23-88). Here the contract is made STRICTLY order
independent: f64 sums use binned error-free extraction (Rump/Ogita/Oishi
ExtractVector as organized by Demmel & Nguyen's reproducible summation) —
each element's mantissa bits are split on a fixed absolute grid derived
only from the global max |x| and constant parameters, so every per-level
partial sum is EXACT in f64 (no rounding ever happens until the final
K-term combine). Exact sums are associative, so any summation order
produces bit-identical doubles, and the results equal the JAX package's
bit for bit.

Every function takes a tensor (on any device) or a list of per-shard
tensors (the single controller's sharded form, parallel/sharded.py; each
shard on its own device), with an optional elementwise multiplier (the
product variants) and an optional mask selecting the elements to count
(owned rows, so halo rows are not counted twice), each of the same form.
Across shards the global max that anchors the bins is the max of the
shards' maxima, each shard's exact per-level partials are computed on its
own device, and the partials are added in shard order on the first shard's
device: the JAX package's `psum` of the same partials, exact and hence
bit for bit the one-array sum whatever the shard count. float32 inputs use
integer-digit bins (`reprod_sum_f32`); other dtypes the double-double
pairwise tree, whose per-shard (hi, lo) pairs combine in shard order by the
ddSum rule (reproducible per decomposition only, as in the reference).
`axis_name` is the JAX package's collective axis; the port names shards by
list position, so it must be None.
"""

from __future__ import annotations

from typing import Optional

import torch


def _no_axis(axis_name) -> None:
    if axis_name is not None:
        raise ValueError(
            f"axis_name={axis_name!r}: the port has no collective axis; "
            f"pass the shards as a list of tensors")


def _shards(x, multiplier, mask):
    """The masked, multiplied summands as a list (one entry per shard; one
    entry for a plain tensor)."""
    if isinstance(x, torch.Tensor):
        return [_masked(x, multiplier, mask)]
    n = len(x)
    mult = [None] * n if multiplier is None else list(multiplier)
    msk = [None] * n if mask is None else list(mask)
    if len(mult) != n or len(msk) != n:
        raise ValueError("multiplier and mask must list one entry a shard")
    return [_masked(a, m, k) for a, m, k in zip(x, mult, msk)]


def _masked(x, multiplier, mask):
    v = x if multiplier is None else x * multiplier
    if mask is not None:
        v = torch.where(mask, v, torch.zeros((), dtype=v.dtype,
                                             device=v.device))
    return v


def _combine_max(vals):
    """max over shards of per-shard scalars, on the first shard's device"""
    dev = vals[0].device
    out = vals[0]
    for v in vals[1:]:
        out = torch.maximum(out, v.to(dev))
    return out


def _psum(parts):
    """per-shard exact partials added in shard order (the psum)"""
    dev = parts[0].device
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(dev)
    return total


def _two_sum(a, b):
    """Knuth error-free transformation: a + b = s + err exactly."""
    s = a + b
    v = s - a
    err = (a - (s - v)) + (b - v)
    return s, err


def _dd_add(x, y):
    """Add two double-double numbers (hi, lo) (the ddSum MPI_Op,
    base/Reductions.h:71-88)."""
    (xh, xl), (yh, yl) = x, y
    s, e = _two_sum(xh, yh)
    e = e + (xl + yl)
    hi, lo = _two_sum(s, e)
    return hi, lo


def dd_sum(x, multiplier=None, mask=None):
    """Compensated (double-double) sum of all elements of `x`.

    Returns the (hi, lo) pair. Accumulation is a deterministic pairwise
    tree over the flattened array (padded with zeros to a power of two),
    so repeated runs are bit-for-bit.
    """
    flat = _masked(x, multiplier, mask).reshape(-1)
    n = flat.shape[0]
    p = 1 if n <= 1 else 1 << (n - 1).bit_length()
    hi = torch.cat([flat, flat.new_zeros(p - n)])
    lo = torch.zeros_like(hi)
    while hi.shape[0] > 1:
        half = hi.shape[0] // 2
        hi, lo = _dd_add((hi[:half], lo[:half]), (hi[half:], lo[half:]))
    return hi[0], lo[0]


# --- reproducible (order-invariant) f64 summation -----------------------
#
# NBITS bounds the element count (2^NBITS - 1 summands), W is the
# per-level bin width. Exactness of the per-level sums needs
#   sigma_k >= 2 n max|residual_k|   and   W <= 52 - NBITS
# (partial sums are multiples of ulp(sigma)/2 bounded by sigma, hence
# representable). W=18 and K=6 give 108 bits beyond the leading one.
_REPROD_NBITS = 32
_REPROD_W = 18
_REPROD_K = 6


def _pow2(e, dtype, device):
    """2^e for an integer tensor e, exactly, in `dtype`."""
    return torch.ldexp(torch.ones((), dtype=dtype, device=device), e)


def reprod_partials(v, sigma0, levels: int = _REPROD_K):
    """Per-level exact bin sums of `v` on the grid anchored at sigma0: a
    (levels,) tensor, high bins first. Every S_k is an exact multiple of
    ulp(sigma_k)/2 whose accumulation never rounded."""
    flat = v.reshape(-1)
    parts = []
    sigma = sigma0
    for _ in range(levels):
        q = (sigma + flat) - sigma          # error-free extraction (Rump)
        parts.append(torch.sum(q))          # exact: no rounding possible
        flat = flat - q                     # exact (Sterbenz)
        sigma = sigma * (2.0 ** -_REPROD_W)
    return torch.stack(parts)


def _reprod_sigma0(gmax):
    """Power of two >= 2^(NBITS+1) * max|x| (the +1 keeps every partial
    sum strictly under sigma, i.e. under 2^53 ulps, so it stays exactly
    representable)."""
    _, e = torch.frexp(gmax)                # gmax = m * 2^e, m in [0.5, 1)
    sigma = _pow2(e + _REPROD_NBITS + 1, gmax.dtype, gmax.device)
    return torch.where(gmax > 0, sigma, torch.ones_like(gmax))


def _reprod_combine(parts):
    """Final rounding: add the K exact bin sums high to low (fixed order)."""
    total = parts[0]
    for k in range(1, parts.shape[0]):
        total = total + parts[k]
    return total


def _gmax(v):
    return (torch.max(torch.abs(v)) if v.numel()
            else torch.zeros((), dtype=v.dtype, device=v.device))


def reprod_sum(x, axis_name: Optional[str] = None, multiplier=None,
               mask=None):
    """Order-invariant f64 sum (the strengthened ddSum contract)."""
    _no_axis(axis_name)
    vs = _shards(x, multiplier, mask)
    sigma0 = _reprod_sigma0(_combine_max([_gmax(v) for v in vs]))
    parts = [reprod_partials(v, sigma0.to(v.device)) for v in vs]
    return _reprod_combine(_psum(parts))


# f32 variant: integer-bin extraction into int32 DIGITS. The f64 scheme's
# per-level float capacity (W <= 52 - log2 n) collapses at 24-bit
# mantissas, so each error-free extract becomes exact integer arithmetic:
# with sigma_k = 2^(e_k) >= 2^12 * 2 max|residual|, q = fl(sigma + x) -
# sigma is a multiple of the grid g = 2^(e_k - 24) with |q/g| <= 2^12, so
# q * 2^(24 - e_k) is an exactly representable 12-bit integer. Chunked
# integer sums (chunk 2^18: partials <= 2^30) are exact, hence
# associative; each level total travels as three base-2^15 digits that
# are CANONICALIZED (carries propagated) before the final f32 combine.
# Six 12-bit levels recover 72 bits below the leading one.
_REPROD32_LEVELS = 6
_R32_W = 12


def _digits_of(part):
    """(sum d0, sum d1, sum d2) base-2^15 digit sums of integer values
    (arithmetic >> gives floored quotients, & gives nonneg remainders,
    so value = d0 + d1*2^15 + d2*2^30 exactly, sign carried by d2)."""
    d0 = part & 0x7fff
    r = part >> 15
    d1 = r & 0x7fff
    d2 = r >> 15
    return torch.stack([torch.sum(d0), torch.sum(d1), torch.sum(d2)])


def _reprod32_partials(v, e1, levels: int = _REPROD32_LEVELS):
    """(levels, 3) exact digit sums of f32 `v`; e1 = exponent of
    sigma0 (sigma0 = 2^e1 >= 2^12 * 2 max|x|)."""
    flat = v.reshape(-1)
    n = flat.shape[0]
    c = 1 << 18
    parts = []
    for k in range(levels):
        ek = e1 - _R32_W * k
        sigma = _pow2(ek, v.dtype, v.device)
        q = (sigma + flat) - sigma
        inv = _pow2(24 - ek, v.dtype, v.device)
        qi = (q * inv).to(torch.int32)          # |qi| <= 2^12, exact
        if n > c:
            pad = (-n) % c
            qp = torch.cat([qi, qi.new_zeros(pad)])
            part = torch.sum(qp.reshape(-1, c), dim=1)   # <= 2^30 each
        else:
            part = torch.sum(qi)[None]
        parts.append(_digits_of(part))
        flat = flat - q
    return torch.stack(parts)


def _reprod32_combine(parts, e1, dtype):
    """Canonicalize digits (value-determined form) and combine in f32
    high level to low — deterministic given the level values alone."""
    total = torch.zeros((), dtype=dtype, device=parts.device)
    for k in range(parts.shape[0]):
        d0, d1, d2 = parts[k, 0], parts[k, 1], parts[k, 2]
        c0 = d0 & 0x7fff
        t1 = d1 + (d0 >> 15)
        c1 = t1 & 0x7fff
        c2 = d2 + (t1 >> 15)
        lvl = ((c2.to(dtype) * 32768.0 + c1.to(dtype)) * 32768.0
               + c0.to(dtype))
        g = _pow2(e1 - _R32_W * k - 24, dtype, parts.device)
        total = total + lvl * g
    return total


def reprod_sum_f32(x, axis_name: Optional[str] = None, multiplier=None,
                   mask=None):
    """Order-invariant f32 sum (integer digit bins; see above)."""
    _no_axis(axis_name)
    vs = _shards(x, multiplier, mask)
    gmax = _combine_max([_gmax(v) for v in vs])
    _, e = torch.frexp(gmax)                # gmax = m * 2^e, m in [.5,1)
    # sigma0 = 2^(e + 13) >= 2^12 * 2 * gmax (12-bit extraction window)
    e1 = torch.where(gmax > 0, e + 13, torch.full_like(e, 13))
    parts = [_reprod32_partials(v, e1.to(v.device)) for v in vs]
    return _reprod32_combine(_psum(parts), e1, vs[0].dtype)


def global_sum(x, axis_name: Optional[str] = None, multiplier=None,
               mask=None):
    """Reproducible global sum (globalSum, base/Reductions.h:51,199-238).

    f64 inputs use the order-invariant binned extraction, f32 the
    order-invariant integer-bin extraction: results are bit-for-bit
    identical across reduction orders, element permutations and shard
    counts. Other dtypes use the double-double pairwise tree, the shards'
    (hi, lo) pairs combined in shard order."""
    _no_axis(axis_name)
    dtype = (x if isinstance(x, torch.Tensor) else x[0]).dtype
    if dtype == torch.float64:
        return reprod_sum(x, None, multiplier, mask)
    if dtype == torch.float32:
        return reprod_sum_f32(x, None, multiplier, mask)
    pairs = [dd_sum(v) for v in _shards(x, multiplier, mask)]
    hi, lo = pairs[0]
    for h, l in pairs[1:]:
        hi, lo = _dd_add((hi, lo), (h.to(hi.device), l.to(hi.device)))
    return hi + lo


def global_min(x, axis_name: Optional[str] = None, mask=None):
    """globalMinVal (base/Reductions.h:637)."""
    _no_axis(axis_name)
    vs = [torch.min(torch.where(k, v, torch.full_like(v, float("inf")))
                    if k is not None else v)
          for v, k in _pairs(x, mask)]
    return -_combine_max([-v for v in vs])


def global_max(x, axis_name: Optional[str] = None, mask=None):
    """globalMaxVal (base/Reductions.h:757)."""
    _no_axis(axis_name)
    vs = [torch.max(torch.where(k, v, torch.full_like(v, float("-inf")))
                    if k is not None else v)
          for v, k in _pairs(x, mask)]
    return _combine_max(vs)


def _pairs(x, mask):
    if isinstance(x, torch.Tensor):
        return [(x, mask)]
    return list(zip(x, [None] * len(x) if mask is None else mask))
