"""Reproducible global reductions, single device.

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

The port runs on one device: `axis_name` must be None. The cross-device
combine (the partials summed over ranks) comes with the distributed layer.

All functions take tensors (on any device) and accept an optional
elementwise multiplier (the product variants) and an optional mask
selecting the elements to count. float32 inputs use integer-digit bins
(`reprod_sum_f32`); other dtypes the double-double pairwise tree.
"""

from __future__ import annotations

from typing import Optional

import torch


def _single_device(axis_name) -> None:
    if axis_name is not None:
        raise NotImplementedError(
            f"axis_name={axis_name!r}: cross-device reductions come with "
            f"the distributed layer (ROADMAP.md queue 1's `parallel/` "
            f"item); the port reduces on one device")


def _masked(x, multiplier, mask):
    v = x if multiplier is None else x * multiplier
    if mask is not None:
        v = torch.where(mask, v, torch.zeros((), dtype=v.dtype,
                                             device=v.device))
    return v


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
    _single_device(axis_name)
    v = _masked(x, multiplier, mask)
    parts = reprod_partials(v, _reprod_sigma0(_gmax(v)))
    return _reprod_combine(parts)


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
    _single_device(axis_name)
    v = _masked(x, multiplier, mask)
    gmax = _gmax(v)
    _, e = torch.frexp(gmax)                # gmax = m * 2^e, m in [.5,1)
    # sigma0 = 2^(e + 13) >= 2^12 * 2 * gmax (12-bit extraction window)
    e1 = torch.where(gmax > 0, e + 13, torch.full_like(e, 13))
    parts = _reprod32_partials(v, e1)
    return _reprod32_combine(parts, e1, v.dtype)


def global_sum(x, axis_name: Optional[str] = None, multiplier=None,
               mask=None):
    """Reproducible global sum (globalSum, base/Reductions.h:51,199-238).

    f64 inputs use the order-invariant binned extraction, f32 the
    order-invariant integer-bin extraction: results are bit-for-bit
    identical across reduction orders and element permutations. Other
    dtypes use the double-double pairwise tree."""
    _single_device(axis_name)
    if x.dtype == torch.float64:
        return reprod_sum(x, None, multiplier, mask)
    if x.dtype == torch.float32:
        return reprod_sum_f32(x, None, multiplier, mask)
    hi, lo = dd_sum(x, multiplier, mask)
    return hi + lo


def global_min(x, axis_name: Optional[str] = None, mask=None):
    """globalMinVal (base/Reductions.h:637)."""
    _single_device(axis_name)
    v = (torch.where(mask, x, torch.full_like(x, float("inf")))
         if mask is not None else x)
    return torch.min(v)


def global_max(x, axis_name: Optional[str] = None, mask=None):
    """globalMaxVal (base/Reductions.h:757)."""
    _single_device(axis_name)
    v = (torch.where(mask, x, torch.full_like(x, float("-inf")))
         if mask is not None else x)
    return torch.max(v)
