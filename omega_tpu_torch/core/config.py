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


def model_config_from_yaml(cfg, nvertlayers: int, ntracers: int) -> ModelConfig:
    """Build the static ModelConfig from a parsed omega.yml Config object
    (the module-init config reads: ocn/Tendencies.cpp init, Advection and
    WindStress groups of configs/Default.yml)."""
    t = cfg.get_group("Tendencies")
    tc = TendencyConfig(
        thickness_flux_div=t.get_bool("ThicknessFluxTendencyEnable", True),
        pv_advection=t.get_bool("PVTendencyEnable", True),
        ke_gradient=t.get_bool("KETendencyEnable", True),
        ssh_gradient=t.get_bool("SSHTendencyEnable", True),
        velocity_diffusion=t.get_bool("VelDiffTendencyEnable", True),
        visc_del2=t.get_float("ViscDel2", 0.0),
        velocity_hyperdiff=t.get_bool("VelHyperDiffTendencyEnable", True),
        visc_del4=t.get_float("ViscDel4", 0.0),
        div_factor=t.get_float("DivFactor", 1.0),
        wind_forcing=t.get_bool("WindForcingTendencyEnable", False),
        density0=t.get_float("Density0", constants.RHO0_SEAWATER),
        bottom_drag=t.get_bool("BottomDragTendencyEnable", False),
        bottom_drag_coeff=t.get_float("BottomDragCoeff", 0.0),
        tracer_horz_adv=t.get_bool("TracerHorzAdvTendencyEnable", True),
        tracer_diffusion=t.get_bool("TracerDiffTendencyEnable", True),
        eddy_diff2=t.get_float("EddyDiff2", 0.0),
        tracer_hyperdiff=t.get_bool("TracerHyperDiffTendencyEnable", True),
        eddy_diff4=t.get_float("EddyDiff4", 0.0),
        use_custom_tendency=t.get_bool("UseCustomTendency", False),
        manufactured_tendency=t.get_bool("ManufacturedSolutionTendency",
                                         False),
    )
    adv = cfg.get_group("Advection") if cfg.exists("Advection") else None
    ws = cfg.get_group("WindStress") if cfg.exists("WindStress") else None
    man = cfg.get_group("ManufacturedSolution") \
        if cfg.exists("ManufacturedSolution") else None
    vm = VertMixConfig()
    if cfg.exists("VertMix"):
        v = cfg.get_group("VertMix")
        vm = VertMixConfig(
            enabled=v.get_bool("Enabled", False),
            kappa_tracer=v.get_float("KappaTracer", 1.0e-5),
            kappa_momentum=v.get_float("KappaMomentum", 1.0e-4),
            method=v.get_str("Method", "pcr").lower(),
            scheme=v.get_str("Scheme", "constant").lower(),
            nu0=v.get_float("Nu0", 1.0e-2),
            alpha=v.get_float("Alpha", 5.0),
            n_exp=v.get_int("NExp", 2),
            eos_alpha_t=v.get_float("EosAlphaT", 2.0e-4),
            eos_beta_s=v.get_float("EosBetaS", 7.6e-4),
        )
    mc = ManufacturedConfig(
        wavelength_x=man.get_float("WavelengthX", 5.0e6) if man else 5.0e6,
        wavelength_y=man.get_float("WavelengthY", 4.33013e6) if man else 4.33013e6,
        amplitude=man.get_float("Amplitude", 1.0) if man else 1.0,
    )
    return ModelConfig(
        nvertlayers=nvertlayers, ntracers=ntracers,
        flux_thickness_type=(adv.get_str("FluxThicknessType", "Center")
                             if adv else "Center").lower(),
        flux_tracer_type=(adv.get_str("FluxTracerType", "Center")
                          if adv else "Center").lower(),
        wind_interp_type=(ws.get_str("InterpType", "Isotropic")
                          if ws else "Isotropic").lower(),
        ssh_formulation=str(cfg.get("SshFormulation", "Stacked")).lower(),
        vert_mix=vm, tendencies=tc, manufactured=mc,
    )
