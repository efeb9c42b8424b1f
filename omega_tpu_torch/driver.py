"""Ocean model driver: init / run / finalize, on one device.

Rewrite of the reference driver stack — ocnInit (ocn/OceanInit.cpp:78-202),
ocnRun (ocn/OceanRun.cpp:16-70), ocnFinalize (ocn/OceanFinal.cpp:25-50) and
the standalone main() (src/drivers/standalone/OceanDriver.cpp:17-72):

    python -m omega_tpu_torch.driver --config omega.yml
    python -m omega_tpu_torch.driver --config omega.yml --device cpu --dtype float64

`ocn_init` follows the reference's phase-ordered module init
(initOmegaModules, OceanInit.cpp:107-202):
  clock/calendar/steppers from TimeIntegration -> IO streams -> field and
  dimension registries -> mesh (file or generator, built on the host and
  moved to the device) -> tracers -> initial state (InitialState stream,
  or RestartRead which resets the model clock from SimulationTime
  metadata) -> the state on the device.

`ocn_run` is the time loop: `stepping.run_steps` advances the device state
one segment at a time, each segment sized to the next host-side alarm
ring, so the steppers' fused kernels run exactly as `run_steps` runs them;
the host clock advances in lock-step; `StreamManager.write_all` fires
alarmed output between segments (OceanRun.cpp:62), which is the only time
the state is copied to the host.

`ocn_finalize` flushes on-shutdown streams and returns the final state.

The device and floating-point type are explicit: `device=None` means the
CUDA device (omega_tpu_torch.default_device, which raises without one);
the tests pass device="cpu" and dtype=torch.float64.

The Decomp group (NShards, Method auto|structured|sfc|patch, ShardedIO,
HaloWidth; the reference's Decomp.DecompMethod / HaloWidth,
base/Decomp.h:19-30) runs the model on NShards shards held by one
controller (parallel/sharded.py), each on a device of
`parallel.sharded.default_devices` (the visible cards in turn; on one card
every shard on it) or, for a CPU model, on the CPU: the structure-preserving
row / column blocks of a planar hex mesh (the fused FB step a shard),
the general SFC decomposition for any other mesh, or whole patches of a
PatchLayout sphere (the patch kernels a shard). The state stays sharded
across segments and is gathered only for IO and analysis — not even then
with ShardedIO, where the streams write each shard's owned rows in place
and the startup state is read shard by shard.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import numpy as np
import torch

from omega_tpu_torch import constants, resolve_device
from omega_tpu_torch.core.config import ModelConfig, model_config_from_yaml
from omega_tpu_torch.core.state import ModelState
from omega_tpu_torch.core.tracers import (TracerSet, register_tracer_fields,
                                          select_tracers)
from omega_tpu_torch.infra.config import Config, default_config
from omega_tpu_torch.infra.dimension import DimensionRegistry
from omega_tpu_torch.infra.errors import ConfigError, OmegaError
from omega_tpu_torch.infra.field import FieldRegistry
from omega_tpu_torch.infra.logging import get_logger
from omega_tpu_torch.infra.timers import Timers
from omega_tpu_torch.infra.time_manager import (Alarm, Calendar, CalendarKind,
                                                Clock, TimeInstant,
                                                TimeInterval)
from omega_tpu_torch.io.netcdf import read_netcdf
from omega_tpu_torch.io.stream import _TIME_UNIT_NAMES, StreamManager
from omega_tpu_torch.mesh.horz_mesh import HorzMesh
from omega_tpu_torch.stepping.steppers import make_stepper, run_steps

@dataclasses.dataclass
class OceanModel:
    """Everything ocn_run needs; the analogue of the reference's collection
    of module singletons after initOmegaModules."""
    config: Config
    model_cfg: ModelConfig
    mesh: HorzMesh                  # on `device`, floats in `dtype`
    calendar: Calendar
    clock: Clock
    end_alarm: Alarm
    streams: StreamManager
    fields: FieldRegistry
    dims: DimensionRegistry
    tracers: TracerSet
    stepper: Callable
    dt: float
    state: ModelState
    device: torch.device = None
    dtype: torch.dtype = torch.float32
    timers: Timers = None
    sim_start: TimeInstant = None   # original simulation start (forcing t=0);
                                    # survives restart via file metadata
    wind_stress: object = None      # optional (zonal, merid) cell tensors
    # time-varying forcing loaded from a read stream: (times_sec (T,),
    # zonal (T, C), merid (T, C)) numpy arrays; linearly interpolated
    # between frames at each segment boundary
    wind_forcing: object = None
    directory: str = "."
    step_count: int = 0
    # online analysis (omega_tpu_torch.analysis): (EnergeticsMonitor, Alarm)
    analysis: object = None
    # active-layer bounds from the InitialVertCoord stream (LayerBounds)
    layer_bounds: object = None
    nshards: int = 1                # Decomp: NShards
    decomp_method: str = "auto"     # Decomp: Method (auto|structured|sfc|patch)
    sharded_io: bool = False        # Decomp: ShardedIO (region reads/writes)
    halo_width: int = 3             # Decomp: HaloWidth (base/Decomp.h:19-30)
    mesh_host: HorzMesh = None      # the mesh as built (host numpy, float64)


_CAL_KINDS = {
    "gregorian": CalendarKind.GREGORIAN,
    "no leap": CalendarKind.NO_LEAP,
    "noleap": CalendarKind.NO_LEAP,
    "julian": CalendarKind.JULIAN,
    "julian day": CalendarKind.JULIAN_DAY,
    "modified julian day": CalendarKind.MOD_JULIAN_DAY,
    "360 day": CalendarKind.DAY_360,
    "no calendar": CalendarKind.NO_CALENDAR,
}


def _build_mesh(cfg: Config, directory: str) -> HorzMesh:
    """Mesh from file (Decomp::readMesh path) or built-in generator, on the
    host (numpy arrays)."""
    if cfg.exists("Mesh"):
        mc = cfg.get_group("Mesh")
        if mc.exists("MeshFileName"):
            from omega_tpu_torch.mesh.mpas_io import read_mpas_mesh
            path = mc.get_str("MeshFileName")
            if not path.startswith("/"):
                path = os.path.join(directory, path)
            return read_mpas_mesh(path)
        if mc.exists("Generate"):
            g = mc.get_group("Generate")
            kind = g.get_str("Kind").lower()
            if kind == "planar":
                from omega_tpu_torch.mesh.planar import planar_hex_mesh
                return planar_hex_mesh(
                    g.get_int("Nx"), g.get_int("Ny"),
                    dc=g.get_float("Dc", 1000.0),
                    f0=g.get_float("F0", 0.0),
                    beta=g.get_float("Beta", 0.0),
                    bottom_depth=g.get_float("BottomDepth", 1000.0))
            if kind == "sphere":
                from omega_tpu_torch.mesh.spherical import spherical_icos_mesh
                subdiv = g.get_int("Subdivisions")
                mesh = spherical_icos_mesh(
                    subdiv,
                    bottom_depth=g.get_float("BottomDepth", 4000.0),
                    lloyd_iters=g.get_int("LloydIters", 0))
                # PatchLayout: renumber onto the 10 n x n rhombus lattice so
                # the patch kernels (ops/patch_megastep.py) apply — the fast
                # path for global runs
                if g.get_bool("PatchLayout", False):
                    from omega_tpu_torch.mesh.icos_patches import \
                        patch_icos_mesh
                    mesh = patch_icos_mesh(mesh, subdiv)
                return mesh
            raise ConfigError(f"unknown mesh Generate Kind {kind!r}")
    raise ConfigError("config needs a Mesh group with MeshFileName or "
                      "Generate")


def _register_fields(fields: FieldRegistry, dims: DimensionRegistry,
                     mesh: HorzMesh, tracers: TracerSet, nvert: int) -> None:
    """Dimensions + State/Restart field groups + tracer fields
    (OceanState/Tracers field registration)."""
    for name, length in (("NCells", mesh.ncells), ("NEdges", mesh.nedges),
                         ("NVertices", mesh.nvertices),
                         ("NVertLayers", nvert)):
        if not dims.exists(name):
            dims.create(name, length)

    if not fields.exists("LayerThickness"):
        fields.create("LayerThickness", description="Layer thickness",
                      units="m", dim_names=("NCells", "NVertLayers"),
                      time_dependent=True, valid_min=0.0)
        fields.create("NormalVelocity",
                      description="Velocity component normal to edge",
                      units="m s-1", dim_names=("NEdges", "NVertLayers"),
                      time_dependent=True)
        fields.create("SshCell", description="Sea surface height", units="m",
                      dim_names=("NCells",), time_dependent=True)
    for gname in ("State", "Restart"):
        if not fields.group_exists(gname):
            fields.create_group(gname)
    fields.add_to_group("State", "LayerThickness", "NormalVelocity")
    register_tracer_fields(fields, tracers)
    fields.add_to_group("Restart", "LayerThickness", "NormalVelocity",
                        *tracers.names)
    if not fields.exists("MinLayerCell"):
        # InitVertCoord group: vert-coord state read from file through
        # the InitialVertCoord stream (VertCoord.cpp:149-206,380-417);
        # 1-based in MPAS files, converted after read
        fields.create("MinLayerCell",
                      description="Index of shallowest active layer",
                      units="1", dim_names=("NCells",))
        fields.create("MaxLayerCell",
                      description="Index of deepest active layer",
                      units="1", dim_names=("NCells",))
        fields.create("BottomDepth",
                      description="Depth of the sea floor", units="m",
                      dim_names=("NCells",))
        fields.create_group("InitVertCoord")
        fields.add_to_group("InitVertCoord", "MinLayerCell",
                            "MaxLayerCell", "BottomDepth")
    if not fields.exists("PressureMid"):
        fields.create("PressureMid", description="Pressure at layer midpoint",
                      units="Pa", dim_names=("NCells", "NVertLayers"),
                      time_dependent=True)
        fields.create("ZMid", description="Geometric height of layer midpoint",
                      units="m", dim_names=("NCells", "NVertLayers"),
                      time_dependent=True)
        fields.create("SpecVol", description="Specific volume",
                      units="m3 kg-1", dim_names=("NCells", "NVertLayers"),
                      time_dependent=True)
        fields.create_group("Diagnostics")
        fields.add_to_group("Diagnostics", "PressureMid", "ZMid", "SpecVol")
    if not fields.exists("ZonalStressCell"):
        # surface wind stress forcing fields, fed through read streams
        # (WindForcingAuxVars.h:13-40 reads ZonalStressCell/MeridStressCell)
        fields.create("ZonalStressCell",
                      description="Zonal surface wind stress",
                      units="N m-2", dim_names=("NCells",),
                      time_dependent=True)
        fields.create("MeridionalStressCell",
                      description="Meridional surface wind stress",
                      units="N m-2", dim_names=("NCells",),
                      time_dependent=True)
    if not fields.exists("code"):
        fields.create_meta("code", model="omega_tpu_torch", version="0.1.0")
    if not fields.exists("simulation"):
        fields.create_meta("simulation")


def _decomp_group(config: Config):
    """(nshards, method, sharded_io, halo_width) of the Decomp group, with
    the reference's checks."""
    nshards, method, sharded_io, halo_width = 1, "auto", False, 3
    if config.exists("Decomp"):
        dc_ = config.get_group("Decomp")
        nshards = dc_.get_int("NShards", 1)
        if nshards < 1:
            raise ConfigError(f"Decomp.NShards must be >= 1, got {nshards}")
        method = dc_.get_str("Method", "auto").lower()
        if method not in ("auto", "structured", "sfc", "patch"):
            raise ConfigError(f"Decomp.Method must be auto|structured|sfc|"
                              f"patch, got {method!r}")
        sharded_io = bool(dc_.get("ShardedIO", False)) and nshards > 1
        halo_width = dc_.get_int("HaloWidth", 3)
        if halo_width < 1:
            raise ConfigError(f"Decomp.HaloWidth must be >= 1, got "
                              f"{halo_width}")
        # RK steppers evaluate del4 (stencil radius 2) twice between
        # exchanges; warn like the reference's TODO (RK4 stepper keeps a
        # mid-step refresh to stay within width 3)
        if halo_width < 3:
            get_logger().warning(
                "Decomp.HaloWidth=%d < 3: multi-stage steppers with "
                "biharmonic mixing may read stale fringe values",
                halo_width)
    return nshards, method, sharded_io, halo_width


def _deferred_stream(streams, fields, tracers, sharded_io, method):
    """With ShardedIO and an explicit sharded decomposition the startup
    state stream is NOT read into a global host array at init; ocn_run
    region-reads each shard's rows once the decomposition's maps exist
    (read-side PIO decomps, base/IO.h:256,305). Restart takes precedence
    over InitialState (ocn/OceanInit.cpp:160-165)."""
    if not (sharded_io and method in ("structured", "sfc")):
        return None
    state_fields = {"LayerThickness", "NormalVelocity", *tracers.names}
    for nm in ("RestartRead", "InitialState"):
        if nm not in streams.streams:
            continue
        s_ = streams.streams[nm]
        if s_.spec.mode != "read" or not s_.on_startup:
            continue
        if not state_fields & set(fields.resolve_contents(s_.spec.contents)):
            continue
        try:
            if os.path.exists(s_.resolve_read_path()):
                return nm
        except OmegaError:
            continue
    return None


def ocn_init(config: Optional[Config] = None, *, directory: str = ".",
             config_file: Optional[str] = None, device=None,
             dtype: torch.dtype = torch.float32) -> OceanModel:
    """Phase-ordered model init (ocnInit, ocn/OceanInit.cpp:78-202).

    `device=None` means the CUDA device (raises without one); `dtype` is
    the state's and the mesh's floating-point type."""
    dev = resolve_device(device)
    if config is None:
        config = (Config.read_all(config_file) if config_file
                  else default_config())
    nshards, decomp_method, sharded_io, halo_width = _decomp_group(config)

    # --- Pacer-style timers from the Timing group (ocn/OceanInit.cpp:46-76)
    timing = config.get_group("Timing") if config.exists("Timing") else None
    timers = Timers(level=timing.get_int("Level", 2) if timing else 2,
                    auto_fence=bool(timing.get("AutoFence", False))
                    if timing else False)

    # --- TimeStepper::init1: calendar, clock, alarms (TimeStepper.cpp:222)
    ti = config.get_group("TimeIntegration")
    cal_name = ti.get_str("CalendarType", "No Leap").lower()
    if cal_name not in _CAL_KINDS:
        raise ConfigError(f"unknown CalendarType {cal_name!r}")
    calendar = Calendar(kind=_CAL_KINDS[cal_name])
    dt_iv = TimeInterval.from_string(ti.get_str("TimeStep"))
    start = TimeInstant.from_string(calendar, ti.get_str("StartTime"))
    clock = Clock(start, dt_iv)

    run_dur = ti.get("RunDuration", "none")
    if isinstance(run_dur, str) and run_dur.lower() not in ("none", ""):
        stop = start + TimeInterval.from_string(run_dur)
    else:
        stop = TimeInstant.from_string(calendar, ti.get_str("StopTime"))
    end_alarm = Alarm("EndAlarm", ring_time=stop)
    clock.attach_alarm(end_alarm)

    # --- mesh (host), tracers, registries
    mesh_np = _build_mesh(config, directory)
    tr_groups = {}
    if config.exists("Tracers"):
        tg = config.get_group("Tracers")
        tr_groups = {k: tg.get_list(k) for k in tg.keys()}
    if not tr_groups:
        tr_groups = {"Base": ["Temperature", "Salinity"]}
    tracers = select_tracers(tr_groups)

    nvert = 1
    if config.exists("VertCoord"):
        nvert = config.get_group("VertCoord").get_int("NVertLayers", 1)
    model_cfg = model_config_from_yaml(config, nvert, tracers.ntracers)
    if model_cfg.vert_mix.scheme == "pp81":
        # resolve the T/S rows the Richardson closure stratifies by
        model_cfg = dataclasses.replace(
            model_cfg, vert_mix=dataclasses.replace(
                model_cfg.vert_mix,
                temp_index=tracers.get_index("Temperature"),
                salt_index=tracers.get_index("Salinity")))

    fields = FieldRegistry()
    dims = DimensionRegistry()
    _register_fields(fields, dims, mesh_np, tracers, nvert)
    fields.update_meta("simulation", StartTime=str(start),
                       TimeStep=ti.get_str("TimeStep"))

    # --- IO streams
    streams_cfg = (config.get_group("IOStreams") if config.exists("IOStreams")
                   else Config("IOStreams", {}))
    streams = StreamManager(streams_cfg, clock, calendar, fields, dims,
                            directory)
    streams.validate_all()

    # --- initial state: defaults, then InitialState / RestartRead streams
    K = nvert
    depth_np = np.asarray(mesh_np.bottom_depth, np.float64)
    h0 = np.broadcast_to(depth_np[:, None] / K, (mesh_np.ncells, K)).copy()
    fields.attach("LayerThickness", h0)
    fields.attach("NormalVelocity", np.zeros((mesh_np.nedges, K)))
    for name in tracers.names:
        fields.attach(name, np.zeros((mesh_np.ncells, K)))

    deferred_stream = _deferred_stream(streams, fields, tracers, sharded_io,
                                       decomp_method)
    if deferred_stream is not None:
        # metadata still comes from the file (the clock reset needs it);
        # the other startup streams read as usual
        meta = {}
        m = streams.read_meta(deferred_stream, force=True)
        if m is not None:
            meta[deferred_stream] = m
        for nm, s_ in streams.streams.items():
            if nm == deferred_stream or s_.spec.mode != "read":
                continue
            if s_.should_act(clock, "startup"):
                m = streams.read(nm, force=True,
                                 missing_ok=nm == "InitialState"
                                 or s_.spec.use_pointer)
                if m is not None:
                    meta[nm] = m
    else:
        meta = streams.read_on_startup(missing_ok_streams=("InitialState",))
    sim_start = start
    if "RestartRead" in meta and "SimulationTime" in meta["RestartRead"]:
        # reset the model clock from restart metadata (OceanInit.cpp:163-177)
        t_restart = TimeInstant.from_string(
            calendar, str(meta["RestartRead"]["SimulationTime"]))
        clock.set_current(t_restart)
        get_logger().info("restart: clock reset to %s", t_restart)
        # original simulation start (forcing time reference) travels in the
        # restart file's StartTime attribute
        if "StartTime" in meta["RestartRead"]:
            sim_start = TimeInstant.from_string(
                calendar, str(meta["RestartRead"]["StartTime"]))
            fields.update_meta("simulation", StartTime=str(sim_start))

    mesh = mesh_np.to(dev, dtype)

    # --- InitialVertCoord stream results (VertCoord.cpp:149-206): layer
    # bounds (1-based in the file) and bottom depth override the mesh
    layer_bounds_m = None
    if (fields.get("MinLayerCell").data is not None
            and fields.get("MaxLayerCell").data is not None):
        from omega_tpu_torch.core import vert_coord as _vc
        min_c = np.asarray(fields.get("MinLayerCell").data, np.int32) - 1
        max_c = np.asarray(fields.get("MaxLayerCell").data, np.int32) - 1
        if fields.get("BottomDepth").data is not None:
            bd = np.asarray(fields.get("BottomDepth").data, np.float64)
            # the override must also refresh the static metadata derived
            # from bottom_depth: the uniform-scalar table (trisk.col and the
            # fused planar kernels read the depth through it) and, if the
            # values actually change, the patch layout (its tables and the
            # patch kernels' weights are built from the host mesh's depth:
            # dropping patch_info sends the mesh to the general path)
            scal = tuple((a, v) for a, v in mesh.structured_scalars
                         if a != "bottom_depth")
            if bd.size and np.ptp(bd) == 0.0:
                scal += (("bottom_depth", float(bd.flat[0])),)
            changed = not np.array_equal(bd, depth_np)
            mesh = dataclasses.replace(
                mesh, bottom_depth=torch.as_tensor(bd, dtype=dtype,
                                                   device=dev),
                structured_scalars=scal,
                patch_info=None if changed else mesh.patch_info)
            mesh_np = dataclasses.replace(
                mesh_np, bottom_depth=bd, structured_scalars=scal,
                patch_info=mesh.patch_info)
            # refresh the default (rest) thickness if no state stream
            # replaced it
            if fields.get("LayerThickness").data is h0:
                h0 = np.broadcast_to(bd[:, None] / K,
                                     (mesh.ncells, K)).copy()
                fields.attach("LayerThickness", h0)
        layer_bounds_m = _vc.layer_bounds(
            mesh, torch.as_tensor(min_c, device=dev),
            torch.as_tensor(max_c, device=dev), K)
        # zero inactive layers in the default thickness
        if fields.get("LayerThickness").data is h0:
            amask = layer_bounds_m.cell_mask(K).cpu().numpy()
            fields.attach("LayerThickness", h0 * amask)
        get_logger().info("InitialVertCoord: layer bounds read "
                          "(%d cells with partial columns)",
                          int((max_c < K - 1).sum() + (min_c > 0).sum()))

    def put(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                               device=dev)

    state = None            # built sharded, by region reads, in ocn_run
    if deferred_stream is None:
        state = ModelState(
            h=put(fields.get("LayerThickness").data),
            u=put(fields.get("NormalVelocity").data),
            tracers=put(np.stack([np.asarray(fields.get(n).data, np.float64)
                                  for n in tracers.names])))

    stepper_name = ti.get_str("TimeStepper", "Forward-Backward")
    if stepper_name.lower().replace(" ", "").replace("-", "").replace(
            "_", "") == "splitexplicit":
        from omega_tpu_torch.stepping import make_split_stepper
        stepper = make_split_stepper(
            n_subcycles=ti.get_int("BarotropicSubcycles", 10),
            bt_drag=ti.get_float("BarotropicLinearDrag", 0.0))
    else:
        stepper = make_stepper(stepper_name)

    # --- optional p-star redistribution phase (VertCoord.PStarEnable):
    # after each step, redistribute column mass onto the target layers
    # and conservatively remap tracers/velocity (computeTargetThickness,
    # VertCoord.cpp:785-840; the remap is roadmap in the reference). The
    # wrapped stepper is not one run_steps fuses: a p-star run takes the
    # composed steps, as in the JAX package. Under sharding the phase runs
    # per shard after the step on its local rows (parallel/sharded.py's
    # post_phase); its edge radius of 1 consumes one halo ring, so the
    # exchange keeps one extra.
    pstar_info = None
    if (config.exists("VertCoord")
            and config.get_group("VertCoord").get_bool("PStarEnable",
                                                       False)):
        if model_cfg.ssh_formulation != "column":
            raise ConfigError(
                "VertCoord.PStarEnable needs SshFormulation: column "
                "(p-star redistributes true column mass)")
        if state is None:
            raise ConfigError("PStarEnable needs a host-read state")
        from omega_tpu_torch.core import vert_coord as _vc2
        _wts = _vc2.movement_weights(_vc2.VertCoordConfig.from_yaml(config,
                                                                    nvert))
        _amask = (layer_bounds_m.cell_mask(nvert, dtype)
                  if layer_bounds_m is not None else None)
        if nshards > 1:
            pstar_info = (state.h, _wts, _amask)
            halo_width = max(halo_width, 4)
        else:
            _phase = _vc2.make_pstar_phase(mesh, state.h, _wts, _amask)
            _base_step = stepper

            def stepper(mesh_, cfg_, st, t, dt, halo, wind_stress=None,
                        **kw):
                out = _base_step(mesh_, cfg_, st, t, dt, halo,
                                 wind_stress=wind_stress, **kw)
                return _phase(out)

    # wind-stress forcing: constant from config (WindStress group), or
    # time-varying frames from a read stream carrying the stress fields
    # (the reference feeds ZonalStressCell/MeridStressCell through the
    # Field/IOStream machinery, WindForcingAuxVars.h:13-40)
    wind = None
    wind_forcing = _load_wind_forcing(streams, calendar, start, directory)
    if wind_forcing is not None:
        times, tzf, tmf = wind_forcing
        wind = (put(tzf[0]), put(tmf[0]))
    elif config.exists("WindStress"):
        wsg = config.get_group("WindStress")
        if wsg.exists("ConstantZonal") or wsg.exists("ConstantMeridional"):
            ones = torch.ones(mesh.ncells, dtype=dtype, device=dev)
            wind = (wsg.get_float("ConstantZonal", 0.0) * ones,
                    wsg.get_float("ConstantMeridional", 0.0) * ones)
    # online analysis cadence (Analysis group; the alarm chunks the run
    # loop like a stream alarm, so samples land on exact boundaries)
    analysis = None
    if config.exists("Analysis"):
        ag = config.get_group("Analysis")
        if ag.get_bool("Enabled", True):
            from omega_tpu_torch.analysis import EnergeticsMonitor
            units = _TIME_UNIT_NAMES.get(
                str(ag.get_str("FreqUnits", "hours")).lower())
            iv = TimeInterval.from_units(ag.get_int("Freq", 1), units)
            al = Alarm("AnalysisAlarm", interval=iv, start=clock.start_time)
            clock.attach_alarm(al)
            mon = EnergeticsMonitor(
                mesh, model_cfg,
                os.path.join(directory,
                             ag.get_str("Filename", "energetics.csv")))
            analysis = (mon, al)

    model = OceanModel(
        config=config, model_cfg=model_cfg, mesh=mesh, calendar=calendar,
        clock=clock, end_alarm=end_alarm, streams=streams, fields=fields,
        dims=dims, tracers=tracers, stepper=stepper,
        dt=float(dt_iv.total_seconds()), state=state, device=dev,
        dtype=dtype, sim_start=sim_start, wind_stress=wind,
        wind_forcing=wind_forcing, timers=timers,
        layer_bounds=layer_bounds_m, directory=directory, analysis=analysis,
        nshards=nshards, decomp_method=decomp_method, sharded_io=sharded_io,
        halo_width=halo_width, mesh_host=mesh_np)
    model._deferred_state_stream = deferred_stream
    model._pstar = pstar_info
    if state is not None:
        _attach_state(model)
    return model


def _wants_diagnostics(model) -> bool:
    for s in model.streams.streams.values():
        if s.spec.mode == "write" and any(
                c in ("Diagnostics", "PressureMid", "ZMid", "SpecVol")
                for c in s.spec.contents):
            return True
    return False


def _attach_diagnostics(model: OceanModel, state: ModelState = None) -> None:
    """EOS + vertical-coordinate diagnostics (Eos::computeSpecVol,
    VertCoord::computePressure/computeZHeight) for streamed output, on the
    state's device."""
    from omega_tpu_torch.core import eos as eos_mod
    from omega_tpu_torch.core import vert_coord

    state = model.state if state is None else state
    h = state.h
    rho0 = constants.RHO0_SEAWATER
    p_int, p_mid = vert_coord.compute_pressure(
        h, torch.zeros(model.mesh.ncells, dtype=h.dtype, device=h.device),
        rho0)
    it = model.tracers.get_index("Temperature")
    isal = model.tracers.get_index("Salinity")
    ec = eos_mod.EosConfig.from_yaml(model.config)
    if it >= 0 and isal >= 0:
        sv = eos_mod.compute_spec_vol(ec, state.tracers[it],
                                      state.tracers[isal], p_mid)
    else:
        sv = torch.full_like(h, 1.0 / rho0)
    z_int, z_mid = vert_coord.compute_z_height(h, sv, model.mesh.bottom_depth,
                                               rho0)
    model.fields.attach("PressureMid", p_mid)
    model.fields.attach("ZMid", z_mid)
    model.fields.attach("SpecVol", sv)


_STRESS_FIELDS = ("ZonalStressCell", "MeridionalStressCell")


def _load_wind_forcing(streams: StreamManager, calendar, sim_start,
                       directory: str):
    """Load time frames of wind stress from a read stream whose Contents
    include the stress fields (the reference's forcing-stream pattern,
    infra/IOStream.h:108 + WindForcingAuxVars.h:13-40).

    Frame times come from a 1-D `Time` variable holding seconds since the
    file's `StartTime` attribute (a time string) or, absent that, since
    the simulation start. Returns (times (T,), zonal (T, C), merid (T, C))
    numpy arrays or None."""
    for name, s in streams.streams.items():
        if s.spec.mode != "read":
            continue
        if not any(f in _STRESS_FIELDS for f in s.spec.contents):
            continue
        path = s.resolve_read_path()
        if not os.path.exists(path):
            raise OmegaError(f"forcing stream {name!r}: file {path} "
                             f"not found")
        nc = read_netcdf(path)
        t0_off = 0.0
        if "StartTime" in nc.attrs:
            t_file = TimeInstant.from_string(calendar,
                                             str(nc.attrs["StartTime"]))
            t0_off = float(t_file.seconds_since(sim_start))
        times = (np.asarray(nc.get("Time"), np.float64) + t0_off
                 if nc.has("Time")
                 else np.zeros(1))
        tz = np.asarray(nc.get("ZonalStressCell"), np.float64)
        tm = (np.asarray(nc.get("MeridionalStressCell"), np.float64)
              if nc.has("MeridionalStressCell") else np.zeros_like(tz))
        if tz.ndim == 1:
            tz, tm = tz[None], tm[None]
        if len(times) != tz.shape[0]:
            raise OmegaError(
                f"forcing stream {name!r}: {len(times)} frame times but "
                f"{tz.shape[0]} stress frames")
        get_logger().info("forcing: %d wind-stress frames from %s",
                          tz.shape[0], path)
        return times, tz, tm
    return None


def _wind_at(model: OceanModel, t_sec: float):
    """Linear interpolation of the forcing frames at time t_sec (seconds
    since simulation start), clamped at the ends (host numpy)."""
    times, tz, tm = model.wind_forcing
    if len(times) == 1 or t_sec <= times[0]:
        return tz[0], tm[0]
    if t_sec >= times[-1]:
        return tz[-1], tm[-1]
    i = int(np.searchsorted(times, t_sec, side="right") - 1)
    w = (t_sec - times[i]) / (times[i + 1] - times[i])
    return ((1 - w) * tz[i] + w * tz[i + 1],
            (1 - w) * tm[i] + w * tm[i + 1])


def _attach_state(model: OceanModel, state: ModelState = None) -> None:
    """Re-attach current state tensors to their fields (the per-step Field
    re-attachment of OceanState::updateTimeLevels, OceanState.cpp:333-365).
    The tensors stay on the device; the copy to the host happens only when
    a stream writes them."""
    state = model.state if state is None else state
    model.fields.attach("LayerThickness", state.h)
    model.fields.attach("NormalVelocity", state.u)
    model.fields.attach("SshCell", column_ssh(state.h,
                                              model.mesh.bottom_depth))
    for i, name in enumerate(model.tracers.names):
        model.fields.attach(name, state.tracers[i])
    if _wants_diagnostics(model):
        _attach_diagnostics(model, state)
    model.fields.update_meta("simulation",
                             SimulationTime=str(model.clock.get_current_time()))


def column_ssh(h, depth):
    """sum_k h - depth a column, summed in float64 and rounded once to h's
    type: a float32 column of 100 layers sums exactly in float64, so the
    value is the same whatever order the reduction takes (on the card the
    order depends on the array's shape: a shard's rows against the whole
    mesh's)."""
    return (h.double().sum(-1) - depth.double()).to(h.dtype)


def _steps_until_next_alarm(model: OceanModel, max_chunk: int = 512) -> int:
    """Size the segment: stop at the next alarm ring so host IO happens at
    exactly the right step."""
    now = model.clock.get_current_time()
    dt = model.clock.step.seconds
    horizon = max_chunk
    for alarm in model.clock.alarms:
        if alarm.stopped or alarm.is_ringing():
            continue
        nxt = alarm.next_ring
        if nxt.elapsed <= now.elapsed:
            continue
        nsteps = -((now.elapsed - nxt.elapsed) // dt)   # ceil division
        horizon = min(horizon, int(nsteps))
    return max(1, horizon)


def _read_state_sharded_region(model: OceanModel, devices) -> list:
    """Region-read the deferred startup stream straight into the per-shard
    state — the read-side PIO decomposition (base/IO.h:256,305): each
    shard's local rows (owned + halo) come off disk individually, so no
    global state array ever exists on the host. Fields absent from the
    file fall back to the default initial state, built per shard."""
    c_l2g, _, e_l2g, _, _ = model._sharded_io_maps
    K = model.model_cfg.nvertlayers
    depth = np.asarray(model.mesh_host.bottom_depth, np.float64)
    put = lambda a, dev: torch.as_tensor(np.asarray(a, np.float64),
                                         dtype=model.dtype, device=dev)
    out = []
    with model.streams.region_reader(model._deferred_state_stream) as r:
        for s, dev in enumerate(devices):
            crows = np.maximum(c_l2g[s], 0)
            erows = np.maximum(e_l2g[s], 0)
            if r.has("LayerThickness"):
                h_s = r.read_rows("LayerThickness", crows)
            else:
                h_s = np.broadcast_to(depth[crows][:, None] / K,
                                      (crows.size, K))
            u_s = (r.read_rows("NormalVelocity", erows)
                   if r.has("NormalVelocity") else np.zeros((erows.size, K)))
            tr_s = np.stack([r.read_rows(nm, crows) if r.has(nm)
                             else np.zeros((crows.size, K))
                             for nm in model.tracers.names])
            out.append(ModelState(h=put(h_s, dev), u=put(u_s, dev),
                                  tracers=put(tr_s, dev)))
    return out


def _attach_state_sharded(model: OceanModel) -> None:
    """Attach the sharded state as ShardedFieldData wrappers so streams
    region-write each shard's owned rows at their global offsets without a
    global gather (the PIO-decomp write path, base/IO.h:256,305)."""
    from omega_tpu_torch.io.stream import ShardedFieldData

    c_l2g, c_own, e_l2g, e_own, depth = model._sharded_io_maps
    sts = model.state
    C, E = model.mesh.ncells, model.mesh.nedges
    f = model.fields
    f.attach("LayerThickness",
             ShardedFieldData([st.h for st in sts], c_l2g, c_own, C))
    f.attach("NormalVelocity",
             ShardedFieldData([st.u for st in sts], e_l2g, e_own, E))
    f.attach("SshCell", ShardedFieldData(
        [column_ssh(st.h, d) for st, d in zip(sts, depth)], c_l2g, c_own, C))
    for i, name in enumerate(model.tracers.names):
        f.attach(name, ShardedFieldData([st.tracers[i] for st in sts],
                                        c_l2g, c_own, C))
    if _wants_diagnostics(model):
        get_logger().warning("ShardedIO: diagnostics fields are not "
                             "computed on the sharded IO path")
    model.fields.update_meta(
        "simulation", SimulationTime=str(model.clock.get_current_time()))


def _shard_devices(model: OceanModel) -> list:
    """The shards' devices: the visible cards in turn for a model on the
    card, the model's device for one on the CPU."""
    if model.device is not None and model.device.type == "cuda":
        from omega_tpu_torch.parallel.sharded import default_devices
        return default_devices(model.nshards)
    return [model.device] * model.nshards


def _setup_sharded(model: OceanModel):
    """Build the decomposition ocn_run runs on and its segment function,
    segment(state, t0, nsteps, wind) -> state, kept in model._run_ctx."""
    from omega_tpu_torch.parallel import patch_shard, sharded
    from omega_tpu_torch.parallel import structured_shard as sshard
    from omega_tpu_torch.stepping.steppers import forward_backward_step

    mesh, cfg, dtype = model.mesh, model.model_cfg, model.dtype
    devices = _shard_devices(model)
    # the p-star post-phase is implemented on the general SFC
    # decomposition; under 'auto' just route there, and only an EXPLICIT
    # patch/structured request errors (below)
    pstar_on = getattr(model, "_pstar", None) is not None
    on_card = devices[0].type == "cuda"

    use_patch = False
    if not (pstar_on and model.decomp_method == "auto") and (
            model.decomp_method == "patch"
            or (model.decomp_method == "auto" and on_card)):
        # the sphere's fast path: whole rhombi a shard, the patch kernels
        # a shard, copies between shards for the frame refresh
        eligible = (mesh.patch_info is not None
                    and model.stepper is forward_backward_step
                    and patch_shard.supported(mesh, cfg, model.nshards))
        if eligible:
            use_patch = True
        elif model.decomp_method == "patch":
            raise ConfigError(
                "Decomp.Method: patch needs a PatchLayout sphere mesh, "
                "NShards in (2, 5, 10), the forward-backward stepper "
                "and the flagship tendency configuration")

    use_structured = False
    ss = None
    if not use_patch and not (pstar_on and model.decomp_method == "auto") \
            and model.decomp_method in ("auto", "structured"):
        try:
            ss = sshard.decompose_structured(
                model.mesh_host, model.nshards,
                hw=model.halo_width + model.halo_width % 2)
            use_structured = True
        except ValueError:
            if model.decomp_method == "structured":
                raise
            get_logger().info(
                "Decomp: mesh not structured-shardable, using the general "
                "SFC decomposition")

    if pstar_on and (use_patch or use_structured):
        raise ConfigError(
            "VertCoord.PStarEnable under sharding uses the general SFC "
            "decomposition (set Decomp.Method: sfc)")

    if use_patch:
        run_p = patch_shard.make_patch_sharded_run(mesh, cfg, model.nshards,
                                                   devices)
        model._decomp = ("patch", None, devices)
        model._gather = lambda st: st            # the state stays global
        if model.sharded_io:
            get_logger().info("ShardedIO: not needed on the patch path "
                              "(IO sees the global state)")
            model.sharded_io = False
        model._scatter_wind = lambda w: w

        def segment(state, t0, nsteps, wind=None):
            return run_p(state, t0, model.dt, nsteps,
                         wind_stress=model.wind_stress if wind is None
                         else wind)
        model._run_ctx = {"segment": segment, "scatter": None}
        return

    if use_structured:
        sstep = sshard.make_sharded_step(ss, cfg, model.stepper, devices,
                                         wind_stress=model.wind_stress,
                                         dtype=dtype)
        model._decomp = ("structured", ss, devices)
        model._gather = lambda st: sshard.gather_state(ss, st)
        scatter = lambda st: sshard.shard_state(ss, st, devices)
        if model.analysis is not None:
            model._sharded_energetics = sshard.make_sharded_energetics(
                ss, cfg, devices, dtype)
        if model.sharded_io:
            c_l2g, c_own = sshard.element_maps(ss, "cell")
            e_l2g, e_own = sshard.element_maps(ss, "edge")
            depth = [m.bottom_depth for m in sstep.meshes]
            model._sharded_io_maps = (c_l2g, c_own, e_l2g, e_own, depth)
    else:
        from omega_tpu_torch.parallel.decomp import decompose
        sm_d = decompose(model.mesh_host, model.nshards,
                         halo_width=model.halo_width).to(devices, dtype)
        model._decomp = ("sfc", sm_d, devices)
        post_phase = None
        if pstar_on:
            # p-star per shard: the reference thickness and active mask
            # scattered to local rows; the phase is rebuilt on the local
            # mesh each call
            from omega_tpu_torch.core import vert_coord as _vc2
            ref_g, wts_p, amask_g = model._pstar
            c_l2g = np.maximum(sm_d.cell_local_to_global, 0)
            aux = {"ref": ref_g.cpu().numpy()[c_l2g]}
            if amask_g is not None:
                aux["mask"] = amask_g.cpu().numpy()[c_l2g]

            def pstar_fn(local_mesh, st, aux_l):
                return _vc2.make_pstar_phase(local_mesh, aux_l["ref"], wts_p,
                                             aux_l.get("mask"))(st)
            post_phase = (pstar_fn, aux)
        sstep = sharded.make_sharded_step(sm_d, cfg, model.stepper, devices,
                                          wind_stress=model.wind_stress,
                                          post_phase=post_phase, dtype=dtype)
        model._gather = lambda st: sharded.gather_state(
            sm_d, st, mesh.ncells, mesh.nedges)
        scatter = lambda st: sharded.shard_state(sm_d, st, devices)
        if model.analysis is not None:
            model._sharded_energetics = sharded.make_sharded_energetics(
                sm_d, cfg, devices, dtype)
        if model.sharded_io:
            model._sharded_io_maps = (
                sm_d.cell_local_to_global, sm_d.owned_cell_mask > 0,
                sm_d.edge_local_to_global, sm_d.owned_edge_mask > 0,
                [m.bottom_depth for m in sm_d.meshes])
    if getattr(model, "_deferred_state_stream", None):
        model.state = _read_state_sharded_region(model, devices)
        model._state_is_sharded = True
    model._scatter_wind = sstep.scatter_wind

    def segment(states, t0, nsteps, wind=None):
        t = t0
        for _ in range(nsteps):
            states = sstep(states, t, model.dt, wind)
            t = t + model.dt
        return states
    model._run_ctx = {"segment": segment, "scatter": scatter}


def ocn_run(model: OceanModel, progress_every: int = 0) -> OceanModel:
    """Time loop until EndAlarm rings (ocnRun, ocn/OceanRun.cpp:16-70).

    With Decomp.NShards > 1 the loop runs the decomposition `Decomp.Method`
    selects (auto: the patch layout for a PatchLayout sphere on the card,
    else the structured blocks of a planar hex mesh, else SFC) over the
    shard list; the state stays sharded across segments and is gathered
    only at IO boundaries. The run context (decomposition, sharded step)
    is built once and kept on the model, so repeated calls — a restart
    chain, or the coupled component advancing one coupling interval at a
    time (omega_tpu_torch.coupling) — reuse it."""
    sharded = model.nshards > 1
    if sharded and getattr(model, "_run_ctx", None) is None:
        _setup_sharded(model)
    if (sharded and model._run_ctx["scatter"] is not None
            and not getattr(model, "_state_is_sharded", False)):
        model.state = model._run_ctx["scatter"](model.state)
        model._state_is_sharded = True
    return _run_loop(model, sharded, progress_every)


def _run_loop(model: OceanModel, sharded: bool,
              progress_every: int) -> OceanModel:
    log = get_logger()
    tm = model.timers
    held = sharded and getattr(model, "_state_is_sharded", False)

    def _fence():
        st = model.state[0] if isinstance(model.state, list) else model.state
        return st.h

    def _sample_analysis():
        mon, _ = model.analysis
        sfn = getattr(model, "_sharded_energetics", None)
        if held and sfn is not None:
            # owned-masked reductions over the shards — no global gather at
            # the sample boundary (analysis.energetics_local)
            row, mon.ssh_ref = sfn(model.state, mon.ssh_ref)
            mon.write_row(row, str(model.clock.get_current_time()))
            return
        st = model._gather(model.state) if held else model.state
        mon.sample(st, str(model.clock.get_current_time()))

    if model.analysis is not None and not model.analysis[0]._wrote_header:
        _sample_analysis()                     # t = 0 row (sets ssh_ref)

    while not model.end_alarm.is_ringing():
        n = _steps_until_next_alarm(model)
        t0 = model.clock.get_current_time().seconds_since(model.sim_start)
        wind_seg = None
        if model.wind_forcing is not None:
            # piecewise-constant-in-segment sampling of the linear
            # interpolant; segments already break at every stream alarm,
            # so a forcing stream's Freq bounds the sampling interval
            wind_seg = tuple(
                torch.as_tensor(w, dtype=model.dtype, device=model.device)
                for w in _wind_at(model, float(t0)))
        elif model.wind_stress is not None:
            # the CURRENT stress: a coupler may replace model.wind_stress
            # between ocn_run calls
            wind_seg = tuple(model.wind_stress)
        with tm.scope("ocnRun/doStep", 1, fence_on=_fence()):
            if sharded:
                if wind_seg is not None:
                    wind_seg = model._scatter_wind(wind_seg)
                model.state = model._run_ctx["segment"](model.state, t0, n,
                                                        wind_seg)
            else:
                # one run_steps call a segment: the fused kernels wherever
                # run_steps takes them, and the state stays on the device
                model.state = run_steps(model.mesh, model.model_cfg,
                                        model.state, t0, model.dt, n,
                                        stepper=model.stepper,
                                        wind_stress=wind_seg)
        for _ in range(n):
            model.clock.advance()
        model.step_count += n
        with tm.scope("ocnRun/io", 1):
            if held and model.sharded_io:
                _attach_state_sharded(model)
            elif held:
                # the gather only where a stream writes now
                if any(s.spec.mode == "write"
                       and s.should_act(model.clock, "step")
                       for s in model.streams.streams.values()):
                    _attach_state(model, model._gather(model.state))
            else:
                _attach_state(model)
            model.streams.write_all()
        if model.analysis is not None and model.analysis[1].is_ringing():
            with tm.scope("ocnRun/analysis", 1):
                _sample_analysis()
        for alarm in model.clock.alarms:
            if alarm.is_ringing() and alarm is not model.end_alarm:
                alarm.reset(model.clock.get_current_time())
        if progress_every and model.step_count % progress_every < n:
            log.info("step %d complete, clock %s", model.step_count,
                     model.clock.get_current_time())
    if held and not getattr(model, "_keep_sharded", False):
        # coupled mode keeps the state sharded (exports are computed from
        # the owned rows, omega_tpu_torch.coupling); otherwise gather here
        model.state = model._gather(model.state)
        model._state_is_sharded = False
    return model


def ocn_finalize(model: OceanModel) -> ModelState:
    """Flush shutdown streams and return final state (ocnFinalize)."""
    if getattr(model, "_state_is_sharded", False):
        model.state = model._gather(model.state)
        model._state_is_sharded = False
    if model.state.h.is_cuda:
        torch.cuda.synchronize(model.state.h.device)
    _attach_state(model)
    model.streams.finalize()
    get_logger().info("ocn_finalize: %d steps, final time %s",
                      model.step_count, model.clock.get_current_time())
    if model.timers is not None and model.timers.totals:
        # the Pacer timing print at shutdown (OceanDriver.cpp:65)
        get_logger().info("timing report:\n%s", model.timers.report())
    return model.state


_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def main(argv=None) -> int:
    """Standalone driver (src/drivers/standalone/OceanDriver.cpp:17-72):
    read omega.yml, init, run to completion."""
    import argparse

    p = argparse.ArgumentParser(prog="omega_tpu_torch.driver",
                                description="PyTorch/CUDA ocean model driver")
    p.add_argument("--config", default="omega.yml",
                   help="YAML config file (default: ./omega.yml)")
    p.add_argument("--dir", default=".", help="run directory")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    p.add_argument("--dtype", default="float32", choices=sorted(_DTYPES),
                   help="floating-point type of the state (default float32)")
    args = p.parse_args(argv)

    model = ocn_init(config_file=args.config, directory=args.dir,
                     device=args.device, dtype=_DTYPES[args.dtype])
    ocn_run(model, progress_every=100)
    ocn_finalize(model)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
