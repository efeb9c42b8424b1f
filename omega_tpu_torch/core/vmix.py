"""Implicit vertical mixing.

The Omega-1 use of the batched tridiagonal solvers (base/TriDiagSolvers.h,
doc/design/OmegaV1GoverningEqns.md): backward-Euler vertical diffusion of
tracers and momentum per column, unconditionally stable for any dt*kappa.

For a field phi with interface diffusivity kappa_{k+1/2} on layers of
pseudo-thickness h_k:

    h_k phi_k^{n+1} - dt [ K_{k+1/2} (phi_{k+1}^{n+1} - phi_k^{n+1})
                         - K_{k-1/2} (phi_k^{n+1} - phi_{k-1}^{n+1}) ]
        = h_k phi_k^n,     K_{k+1/2} = kappa_{k+1/2} / dz_{k+1/2}

which is exactly the diffusion-form system (G, H) of
ops/tridiag.diffusion_solve with G_k = dt K_{k+1/2}, H_k = h_k — no-flux
at surface and bottom by construction.
"""

from __future__ import annotations

import torch

from omega_tpu_torch.ops import tridiag, trisk


def interface_coupling(h, kappa_interface, dt):
    """G_k = dt * kappa_{k+1/2} / dz_{k+1/2}, G_{K-1} = 0.

    h: (..., K) layer thickness; kappa_interface: (..., K-1) or (K-1,)
    diffusivity at interior interfaces [m^2/s].
    """
    dz = 0.5 * (h[..., :-1] + h[..., 1:])
    g_int = dt * kappa_interface / dz
    return torch.cat([g_int, torch.zeros_like(h[..., :1])], dim=-1)


def implicit_vmix(h, kappa_interface, dt, field, method: str = "pcr"):
    """Backward-Euler vertical diffusion of `field` (..., K).

    Conserves the thickness-weighted column integral sum(h * phi) exactly
    (the matrix row sums equal h)."""
    g = interface_coupling(h, kappa_interface, dt)
    return tridiag.diffusion_solve(g, h, h * field, method=method)


def implicit_vmix_velocity(h_edge, kappa_interface, dt, u,
                           method: str = "pcr"):
    """Same solve for normal velocity on edges with edge thickness."""
    return implicit_vmix(h_edge, kappa_interface, dt, u, method=method)


def pp81_coefficients(mesh, vm, gravity, h, u, tracers):
    """Richardson-number mixing coefficients (Pacanowski & Philander
    1981, J. Phys. Oceanogr. 11, the shear-instability closure of
    MPAS-O practice; the reference ships constant coefficients only):

        nu    = Nu0 / (1 + Alpha*Ri)^NExp + KappaMomentum
        kappa = nu  / (1 + Alpha*Ri)      + KappaTracer

    Ri = max(N^2, 0)/shear^2 at the K-1 interior interfaces; N^2 from
    the linear EOS slopes on T/S (unstratified when either is absent,
    so Ri = 0 and mixing peaks — the PP81 convention for instability).
    Returns (kappa_cell (C, K-1), nu_edge (E, K-1))."""
    eps = 1.0e-16
    du = u[..., :-1] - u[..., 1:]                       # (E, K-1)
    dz_e = 0.5 * (h[..., :-1] + h[..., 1:])             # cell dz (C, K-1)

    # buoyancy frequency at cell interfaces (z increases upward; layer
    # k is ABOVE layer k+1, so stable stratification has T_k > T_k+1)
    if vm.temp_index >= 0 and vm.salt_index >= 0:
        T = tracers[vm.temp_index]
        S = tracers[vm.salt_index]
        db = gravity * (vm.eos_alpha_t * (T[..., :-1] - T[..., 1:])
                        - vm.eos_beta_s * (S[..., :-1] - S[..., 1:]))
        n2_cell = torch.clamp(db / dz_e, min=0.0)       # (C, K-1)
    else:
        n2_cell = torch.zeros_like(dz_e)

    # shear^2: at cells via the TRiSK KE average (ke_cell(du) is the
    # kite-weighted mean of du^2/2), at edges directly
    dz_edge = trisk.cell_mean_on_edge(mesh, dz_e)
    shear2_cell = 2.0 * trisk.ke_cell(mesh, du) / (dz_e * dz_e)
    shear2_edge = (du / dz_edge) ** 2

    ri_cell = n2_cell / torch.clamp(shear2_cell, min=eps)
    ri_edge = trisk.cell_mean_on_edge(mesh, n2_cell) \
        / torch.clamp(shear2_edge, min=eps)

    def coeffs(ri):
        f = 1.0 + vm.alpha * torch.clamp(ri, min=0.0)
        nu = vm.nu0 / f ** vm.n_exp
        return nu / f + vm.kappa_tracer, nu + vm.kappa_momentum

    kappa_cell, _ = coeffs(ri_cell)
    _, nu_edge = coeffs(ri_edge)
    return kappa_cell, nu_edge
