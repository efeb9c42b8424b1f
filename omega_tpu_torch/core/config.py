"""Model configuration — frozen (hashable) dataclasses.

The reference reads a YAML config into a hierarchical Config object
(infra/Config.h:32) whose groups are consumed by module init routines
(e.g. Tendencies flags, ocn/Tendencies.h:11-30; Advection flux options,
configs/Default.yml). Here each group is a frozen dataclass; enable flags
are plain Python branches taken when a step is composed.
"""

from __future__ import annotations

import dataclasses

from omega_tpu_torch import constants


@dataclasses.dataclass(frozen=True)
class TendencyConfig:
    """Mirrors the `Tendencies:` config group (configs/Default.yml)."""
    thickness_flux_div: bool = True     # ThicknessFluxTendencyEnable
    pv_advection: bool = True           # PVTendencyEnable
    ke_gradient: bool = True            # KETendencyEnable
    ssh_gradient: bool = True           # SSHTendencyEnable
    velocity_diffusion: bool = True     # VelDiffTendencyEnable
    visc_del2: float = 1.0e3            # ViscDel2 [m^2 s^-1]
    velocity_hyperdiff: bool = True     # VelHyperDiffTendencyEnable
    visc_del4: float = 1.2e11           # ViscDel4 [m^4 s^-1]
    div_factor: float = 1.0             # DivFactor
    wind_forcing: bool = False          # WindForcingTendencyEnable
    density0: float = constants.RHO0_SEAWATER
    bottom_drag: bool = False           # BottomDragTendencyEnable
    bottom_drag_coeff: float = 0.0
    tracer_horz_adv: bool = True        # TracerHorzAdvTendencyEnable
    tracer_diffusion: bool = True       # TracerDiffTendencyEnable
    eddy_diff2: float = 10.0            # EddyDiff2 [m^2 s^-1]
    tracer_hyperdiff: bool = True       # TracerHyperDiffTendencyEnable
    eddy_diff4: float = 0.0             # EddyDiff4 [m^4 s^-1]
    use_custom_tendency: bool = False   # UseCustomTendency
    manufactured_tendency: bool = False # ManufacturedSolutionTendency


@dataclasses.dataclass(frozen=True)
class VertMixConfig:
    """Implicit vertical mixing (the Omega-1 use of the tridiagonal
    solvers, base/TriDiagSolvers.h; config group `VertMix:`).

    Scheme "constant" applies the fixed coefficients; "pp81" is the
    Richardson-number closure of Pacanowski & Philander (1981), the
    shear-instability scheme of MPAS-O practice:

        nu    = Nu0 / (1 + Alpha*Ri)^NExp + KappaMomentum
        kappa = nu  / (1 + Alpha*Ri)      + KappaTracer

    with Ri = max(N^2, 0) / shear^2 at layer interfaces; N^2 from the
    linear EOS slopes (EosAlphaT/EosBetaS) on the Temperature/Salinity
    tracers (indices resolved at model set-up; -1 = unstratified)."""
    enabled: bool = False
    kappa_tracer: float = 1.0e-5     # background tracer diff. [m^2/s]
    kappa_momentum: float = 1.0e-4   # background viscosity [m^2/s]
    method: str = "pcr"              # pcr | thomas
    scheme: str = "constant"         # constant | pp81
    nu0: float = 1.0e-2              # PP81 peak viscosity [m^2/s]
    alpha: float = 5.0               # PP81 Ri coefficient
    n_exp: int = 2                   # PP81 exponent
    eos_alpha_t: float = 2.0e-4      # thermal expansion [1/K]
    eos_beta_s: float = 7.6e-4       # haline contraction [1/(g/kg)]
    temp_index: int = -1             # Temperature tracer row (or -1)
    salt_index: int = -1             # Salinity tracer row (or -1)


@dataclasses.dataclass(frozen=True)
class ManufacturedConfig:
    """Mirrors the `ManufacturedSolution:` config group."""
    wavelength_x: float = 5.0e6
    wavelength_y: float = 4.33013e6
    amplitude: float = 1.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Top-level static model configuration."""
    nvertlayers: int = 1
    ntracers: int = 2
    # Advection group
    flux_thickness_type: str = "center"   # center | upwind
    flux_tracer_type: str = "center"      # center | upwind | fct
    # SSH semantics: "stacked" = per-layer ssh_k = h_k - depth (the
    # reference's current stacked-shallow-water behavior,
    # LayerThicknessAuxVars.h:67-81 "Temporary for stacked shallow water");
    # "column" = true free surface ssh = sum_k h_k - depth (the layered-
    # ocean formulation, required by the split-explicit stepper)
    ssh_formulation: str = "stacked"
    # WindStress group
    wind_interp_type: str = "isotropic"   # isotropic | anisotropic
    vert_mix: VertMixConfig = VertMixConfig()
    tendencies: TendencyConfig = TendencyConfig()
    manufactured: ManufacturedConfig = ManufacturedConfig()
    gravity: float = constants.GRAVITY
