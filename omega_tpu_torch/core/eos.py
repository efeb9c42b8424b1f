"""Equation of state: specific volume from T, S, p.

Rewrite of ocn/Eos.h/.cpp: two EOS choices selected by config
(``Eos: EosType``) — a linear EOS and the Roquet et al. (2015, Ocean
Modelling 90) 75-term polynomial TEOS-10 expansion for specific volume
(the same published coefficient set the reference embeds, validated there
against GSW-C). The reference evaluates per (cell, K-chunk) functors with
a pressure-coefficient scratch array (Eos.h:30-240); here the whole field
is one Horner evaluation over (C, K) tensors, in the order of the JAX
package's, so the two agree to rounding.

The displaced variant evaluates the polynomial at the pressure of layer
K + KDisp (clamped), used for stratification/stability calculations
(Eos.h:60-76).

Units: T = conservative temperature [degC], S = absolute salinity [g/kg],
p = pressure [Pa]; specific volume [m^3/kg].
"""

from __future__ import annotations

import dataclasses

import torch

# ---- TEOS-10 75-term polynomial coefficients (Roquet et al. 2015) ----
# input scalings
_SAU = 40.0 * 35.16504 / 35.0
_CTU = 40.0
_DELTAS = 24.0
_PU = 1.0e8     # Pa per polynomial pressure unit (1e4 dbar, Roquet Pu)

# vijk: i = salinity power (in Ss), j = temperature power (in Tt),
# k = pressure power; value tables from Roquet et al. 2015 appendix
_V = {
    (0, 0, 0): 1.0769995862e-03, (1, 0, 0): -3.1038981976e-04,
    (2, 0, 0): 6.6928067038e-04, (3, 0, 0): -8.5047933937e-04,
    (4, 0, 0): 5.8086069943e-04, (5, 0, 0): -2.1092370507e-04,
    (6, 0, 0): 3.1932457305e-05,
    (0, 1, 0): -1.5649734675e-05, (1, 1, 0): 3.5009599764e-05,
    (2, 1, 0): -4.3592678561e-05, (3, 1, 0): 3.4532461828e-05,
    (4, 1, 0): -1.1959409788e-05, (5, 1, 0): 1.3864594581e-06,
    (0, 2, 0): 2.7762106484e-05, (1, 2, 0): -3.7435842344e-05,
    (2, 2, 0): 3.5907822760e-05, (3, 2, 0): -1.8698584187e-05,
    (4, 2, 0): 3.8595339244e-06,
    (0, 3, 0): -1.6521159259e-05, (1, 3, 0): 2.4141479483e-05,
    (2, 3, 0): -1.4353633048e-05, (3, 3, 0): 2.2863324556e-06,
    (0, 4, 0): 6.9111322702e-06, (1, 4, 0): -8.7595873154e-06,
    (2, 4, 0): 4.3703680598e-06,
    (0, 5, 0): -8.0539615540e-07, (1, 5, 0): -3.3052758900e-07,
    (0, 6, 0): 2.0543094268e-07,
    (0, 0, 1): -1.6784136540e-05, (1, 0, 1): 2.4262468747e-05,
    (2, 0, 1): -3.4792460974e-05, (3, 0, 1): 3.7470777305e-05,
    (4, 0, 1): -1.7322218612e-05, (5, 0, 1): 3.0927427253e-06,
    (0, 1, 1): 1.8505765429e-05, (1, 1, 1): -9.5677088156e-06,
    (2, 1, 1): 1.1100834765e-05, (3, 1, 1): -9.8447117844e-06,
    (4, 1, 1): 2.5909225260e-06,
    (0, 2, 1): -1.1716606853e-05, (1, 2, 1): -2.3678308361e-07,
    (2, 2, 1): 2.9283346295e-06, (3, 2, 1): -4.8826139200e-07,
    (0, 3, 1): 7.9279656173e-06, (1, 3, 1): -3.4558773655e-06,
    (2, 3, 1): 3.1655306078e-07,
    (0, 4, 1): -3.4102187482e-06, (1, 4, 1): 1.2956717783e-06,
    (0, 5, 1): 5.0736766814e-07,
    (0, 0, 2): 3.0623833435e-06, (1, 0, 2): -5.8484432984e-07,
    (2, 0, 2): -4.8122251597e-06, (3, 0, 2): 4.9263106998e-06,
    (4, 0, 2): -1.7811974727e-06,
    (0, 1, 2): -1.1736386731e-06, (1, 1, 2): -5.5699154557e-06,
    (2, 1, 2): 5.4620748834e-06, (3, 1, 2): -1.3544185627e-06,
    (0, 2, 2): 2.1305028740e-06, (1, 2, 2): 3.9137387080e-07,
    (2, 2, 2): -6.5731104067e-07,
    (0, 3, 2): -4.6132540037e-07, (1, 3, 2): 7.7618888092e-09,
    (0, 4, 2): -6.3352916514e-08,
    (0, 0, 3): -3.8088938393e-07, (1, 0, 3): 3.6310188515e-07,
    (2, 0, 3): 1.6746303780e-08,
    (0, 1, 3): -3.6527006553e-07, (1, 1, 3): -2.7295696237e-07,
    (0, 2, 3): 2.8695905159e-07,
    (0, 0, 4): 8.8302421514e-08, (1, 0, 4): -1.1147125423e-07,
    (0, 1, 4): 3.1454099902e-07,
    (0, 0, 5): 4.2369007180e-09,
}

# reference vertical profile v0(p) coefficients (Roquet et al. 2015)
_V0P = (-4.4015007269e-05, 6.9232335784e-06, -7.5004675975e-07,
        1.7009109288e-08, -1.6884162004e-08, 1.9613503930e-09)


def _pcoeff(k, ss, tt):
    """Polynomial coefficient of Pp^k as a function of (Ss, Tt): Horner in
    Tt of Horner-in-Ss rows."""
    out = None
    for j in range(6, -1, -1):
        row = None
        for i in range(6, -1, -1):
            c = _V.get((i, j, k))
            if c is None and row is None:
                continue
            term = torch.zeros_like(ss) if c is None else c
            row = term if row is None else row * ss + term
        if row is None and out is None:
            continue
        row = torch.zeros_like(ss) if row is None else row
        out = row if out is None else out * tt + row
    return out


def teos10_specvol_anomaly(ct, sa, p):
    """Specific-volume anomaly delta(S,T,p) of the 75-term expansion."""
    ss = torch.sqrt((sa + _DELTAS) / _SAU)
    tt = ct / _CTU
    pp = p / _PU
    delta = _pcoeff(5, ss, tt)
    for k in range(4, -1, -1):
        delta = delta * pp + _pcoeff(k, ss, tt)
    return delta


def teos10_ref_profile(p):
    """Reference vertical profile v0(p) (Roquet et al. 2015 eq. 9)."""
    pp = p / _PU
    v0 = _V0P[-1]
    for c in _V0P[-2::-1]:
        v0 = v0 * pp + c
    return v0 * pp


def teos10_specvol(ct, sa, p):
    """TEOS-10 75-term specific volume [m^3/kg]."""
    return teos10_ref_profile(p) + teos10_specvol_anomaly(ct, sa, p)


@dataclasses.dataclass(frozen=True)
class EosConfig:
    """The ``Eos:`` config group (configs/Default.yml)."""
    eos_type: str = "teos10"       # "linear" | "teos10"
    # linear EOS coefficients (Eos.h:244-257)
    drho_dt: float = -0.2          # kg m^-3 degC^-1
    drho_ds: float = 0.8           # kg m^-3 (g/kg)^-1
    rho_t0_s0: float = 1000.0      # kg m^-3

    @classmethod
    def from_yaml(cls, cfg) -> "EosConfig":
        if not cfg.exists("Eos"):
            return cls()
        e = cfg.get_group("Eos")
        lin = e.get_group("Linear") if e.exists("Linear") else None
        return cls(
            eos_type=e.get_str("EosType", "teos10").lower(),
            drho_dt=lin.get_float("DRhoDT", -0.2) if lin else -0.2,
            drho_ds=lin.get_float("DRhoDS", 0.8) if lin else 0.8,
            rho_t0_s0=lin.get_float("RhoT0S0", 1000.0) if lin else 1000.0,
        )


def compute_spec_vol(eos: EosConfig, ct, sa, p):
    """Specific volume for all cells/layers (Eos::computeSpecVol,
    ocn/Eos.cpp:113)."""
    if eos.eos_type == "linear":
        return 1.0 / (eos.rho_t0_s0 + eos.drho_dt * ct + eos.drho_ds * sa)
    if eos.eos_type == "teos10":
        return teos10_specvol(ct, sa, p)
    raise ValueError(f"unknown EosType {eos.eos_type!r}")


def compute_spec_vol_displaced(eos: EosConfig, ct, sa, p, k_disp: int):
    """Specific volume with each parcel's (T, S) evaluated at the pressure
    of layer K + k_disp, clamped to valid layers (Eos::computeSpecVolDisp,
    ocn/Eos.cpp:144; used for static-stability calculations). For the
    linear EOS pressure plays no role, matching the reference's warning
    path."""
    if eos.eos_type == "linear":
        return compute_spec_vol(eos, ct, sa, p)
    K = p.shape[-1]
    idx = torch.clamp(torch.arange(K, device=p.device) + k_disp, 0, K - 1)
    return teos10_specvol(ct, sa, p[..., idx])
