"""The port's infra services (omega_tpu_torch.infra, core.tracers) against
the JAX package's: the cases of tests/test_infra.py and
tests/test_time_manager.py, each run through both packages on the same
inputs, its own checks passing in each and its outputs equal.

Every case takes a namespace `P` of one package's names and returns the
values it computed, as plain Python values."""

import types
from fractions import Fraction

import numpy as np
import pytest

import conftest  # noqa: F401  (forces the JAX CPU backend and x64)

import omega_tpu.core.tracers as j_tracers
import omega_tpu.infra as j_infra
import omega_tpu.infra.config as j_config
import omega_tpu.infra.errors as j_errors
import omega_tpu.infra.timers as j_timers
import omega_tpu_torch.core.tracers as p_tracers
import omega_tpu_torch.infra as p_infra
import omega_tpu_torch.infra.config as p_config
import omega_tpu_torch.infra.errors as p_errors
import omega_tpu_torch.infra.timers as p_timers


def _ns(infra, config, errors, tracers, timers):
    return types.SimpleNamespace(
        Config=config.Config, default_config=config.default_config,
        ConfigError=errors.ConfigError, FieldError=errors.FieldError,
        OmegaError=errors.OmegaError, abort_error=errors.abort_error,
        check_error_abort=errors.check_error_abort,
        DimensionRegistry=infra.DimensionRegistry,
        FieldRegistry=infra.FieldRegistry, Timers=timers.Timers,
        select_tracers=tracers.select_tracers,
        register_tracer_fields=tracers.register_tracer_fields,
        DEFAULT_GROUPS=tracers.DEFAULT_GROUPS,
        Alarm=infra.Alarm, Calendar=infra.Calendar,
        CalendarKind=infra.CalendarKind, Clock=infra.Clock,
        TimeInstant=infra.TimeInstant, TimeInterval=infra.TimeInterval,
        TimeUnits=infra.TimeUnits)


JAX = _ns(j_infra, j_config, j_errors, j_tracers, j_timers)
PORT = _ns(p_infra, p_config, p_errors, p_tracers, p_timers)


def _both(case, *args):
    """The case's outputs in the JAX package and in the port: equal."""
    want = case(JAX, *args)
    got = case(PORT, *args)
    assert got == want
    return got


# ------------------------------------------------------------ config

BATTERY = """
Omega:
  Scalars:
    AnInt: 3
    ABigInt: 123456789012345
    AFloat: 4.5
    ASciFloat: 1.0e3
    ANegSci: -2.5e-4
    ATrue: true
    AFalse: false
    AString: some string
  Vectors:
    Ints: [1, 2, 3]
    Floats: [1.5, 2.0, 3]
    SciFloats: [1.0e3, 2e5]
    Bools: [true, false, true]
    Strings: [a, b, c]
  Nested:
    Inner:
      Deep: 7
"""


def case_default_config(P):
    return P.default_config().as_dict()


def case_default_config_roundtrip(P, tmp):
    cfg = P.default_config()
    tend = cfg.get_group("Tendencies")
    assert tend.get_bool("ThicknessFluxTendencyEnable") is True
    assert tend.get_float("ViscDel2") == 1.0e3
    tend.set("ViscDel2", 5.0)
    with pytest.raises(P.ConfigError):
        tend.set("NoSuchKey", 1)
    tend.add("NewKey", [1, 2, 3])
    with pytest.raises(P.ConfigError):
        tend.add("NewKey", 0)
    tend.remove("NewKey")
    path = str(tmp / "omega.yml")
    cfg.write(path)
    back = P.Config.read_all(path)
    assert back.get_group("Tendencies").get_float("ViscDel2") == 5.0
    return back.as_dict(), open(path).read()


def case_config_type_errors(P):
    cfg = P.default_config()
    tend = cfg.get_group("Tendencies")
    calls = (lambda: tend.get_str("ViscDel2"),
             lambda: tend.get_int("ThicknessFluxTendencyEnable"),
             lambda: cfg.get_group("Tendencies").get_group("ViscDel2"),
             lambda: cfg.get("Missing"))
    for call in calls:
        with pytest.raises(P.ConfigError):
            call()
    return cfg.get("Missing", 42), len(calls)


def case_config_typed_getters(P):
    cfg = P.Config.from_yaml(BATTERY)
    s, v = cfg.get_group("Scalars"), cfg.get_group("Vectors")
    out = (s.get_int("AnInt"), s.get_int("ABigInt"), s.get_float("AFloat"),
           s.get_float("ASciFloat"), s.get_float("ANegSci"),
           s.get_bool("ATrue"), s.get_bool("AFalse"), s.get_str("AString"),
           v.get_int_list("Ints"), v.get_float_list("Floats"),
           v.get_float_list("SciFloats"), v.get_bool_list("Bools"),
           v.get_str_list("Strings"),
           cfg.get_group("Nested").get_group("Inner").get_int("Deep"))
    assert out[3] == 1000.0 and out[10] == [1000.0, 2e5]   # "1.0e3"
    return out, cfg.as_dict()


def case_config_type_mismatch_errors(P):
    cfg = P.Config.from_yaml(BATTERY)
    s = cfg.get_group("Scalars")
    calls = (lambda: s.get_int("AFloat"), lambda: s.get_int("ATrue"),
             lambda: s.get_float("AString"), lambda: s.get_str("AnInt"),
             lambda: s.get_bool("AnInt"), lambda: s.get_int("Missing"),
             lambda: cfg.get_group("Scalars").get_group("AnInt"),
             lambda: cfg.get_group("Vectors").get_int_list("Floats"),
             lambda: cfg.get_group("Vectors").get_bool_list("Ints"))
    msgs = []
    for call in calls:
        with pytest.raises(P.ConfigError) as e:
            call()
        msgs.append(str(e.value))
    return msgs


def case_config_add_set_remove(P, tmp):
    cfg = P.Config.from_yaml(BATTERY)
    s = cfg.get_group("Scalars")
    with pytest.raises(P.ConfigError):
        s.add("AnInt", 9)
    with pytest.raises(P.ConfigError):
        s.set("NewKey", 9)
    s.add("NewKey", 9)
    s.set("AnInt", 42)
    s.remove("AString")
    with pytest.raises(P.ConfigError):
        s.remove("AString")
    cfg.add_group("Added").add("X", [1.0, 2.0])
    path = str(tmp / "round.yml")
    cfg.write(path)
    back = P.Config.read_all(path)
    assert back.as_dict() == cfg.as_dict()
    return back.as_dict(), cfg.to_yaml()


def case_config_queries(P):
    cfg = P.Config.from_yaml(BATTERY)
    return (sorted(cfg.keys()), "Scalars" in cfg, cfg.is_group("Scalars"),
            cfg.get_group("Scalars").is_group("AnInt"),
            [k for k in cfg.get_group("Nested")], repr(cfg))


def test_default_config_is_the_parsed_one():
    """The port holds its defaults as a dict; they equal the JAX package's
    parsed DEFAULT_CONFIG_YAML, "1.0e3"-style numbers included."""
    d = _both(case_default_config)
    assert d["Tendencies"]["ViscDel2"] == 1000.0
    assert d["ManufacturedSolution"]["WavelengthY"] == 4.33013e6


@pytest.mark.parametrize("case", [case_default_config_roundtrip,
                                  case_config_add_set_remove],
                         ids=lambda c: c.__name__)
def test_config_write_read(case, tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    want = case(JAX, tmp_path / "j")
    assert case(PORT, tmp_path / "p") == want


@pytest.mark.parametrize("case", [case_config_type_errors,
                                  case_config_typed_getters,
                                  case_config_type_mismatch_errors,
                                  case_config_queries],
                         ids=lambda c: c.__name__)
def test_config(case):
    _both(case)


def test_config_from_a_dict_reads_as_from_yaml():
    """A Config built from a dict (no YAML text, no PyYAML) reads as the
    parsed text does."""
    doc = JAX.Config.from_yaml(BATTERY).as_dict()
    cfg = PORT.Config("Omega", doc)
    assert case_config_queries(PORT) == (
        sorted(cfg.keys()), "Scalars" in cfg, cfg.is_group("Scalars"),
        cfg.get_group("Scalars").is_group("AnInt"),
        [k for k in cfg.get_group("Nested")], repr(cfg))
    assert cfg.get_group("Scalars").get_float("ASciFloat") == 1000.0
    assert cfg.as_dict() == PORT.Config.from_yaml(BATTERY).as_dict()


# ------------------------------------------- dimensions, fields, tracers

def case_dimension_registry(P):
    reg = P.DimensionRegistry()
    reg.create("NVertLayers", 64)
    d = reg.get("NVertLayers")
    reg.create("NCells", 100, offsets=np.array([0, 1, 2, -1, -1]))
    dc = reg.get("NCells")
    with pytest.raises(P.FieldError):
        reg.create("NCells", 3)
    with pytest.raises(P.FieldError):
        reg.get("Nope")
    out = (d.global_length, d.distributed, d.local_length, dc.distributed,
           dc.local_length, int(dc.owned_mask().sum()), reg.names(),
           reg.exists("NCells"))
    reg.destroy("NCells")
    return out + (reg.names(),)


def case_field_registry(P):
    reg = P.FieldRegistry()
    reg.create("LayerThickness", description="Layer thickness", units="m",
               dim_names=("NCells", "NVertLayers"), time_dependent=True,
               valid_min=0.0, fill_value=1e33, extra="x")
    reg.create("NormalVelocity", units="m s-1",
               dim_names=("NEdges", "NVertLayers"), time_dependent=True)
    reg.create_group("State")
    reg.add_to_group("State", "LayerThickness", "NormalVelocity")
    data = np.ones((4, 2))
    reg.attach("LayerThickness", data)
    assert reg.get("LayerThickness").data is data
    out = reg.resolve_contents(["State", "LayerThickness"])
    with pytest.raises(P.FieldError):
        reg.resolve_contents(["Junk"])
    with pytest.raises(P.FieldError):
        reg.add_to_group("State", "Junk")
    with pytest.raises(P.FieldError):
        reg.create("NormalVelocity")
    reg.create_meta("code", model="m", version="1")
    reg.update_meta("code", extra=3)
    members = reg.group_members("State")
    reg.destroy("NormalVelocity")
    return (members, reg.get("LayerThickness").cf_attrs(), out,
            reg.get("code").meta, reg.group_members("State"), reg.names(),
            reg.groups(), reg.get("LayerThickness").ndims)


def case_tracer_selection(P):
    tset = P.select_tracers(P.DEFAULT_GROUPS)
    base = P.select_tracers({"Base": ["Temperature", "Salinity"]})
    for bad in ({"Base": ["NotATracer"]},
                {"A": ["Temperature"], "B": ["Temperature"]}):
        with pytest.raises(P.ConfigError):
            P.select_tracers(bad)
    with pytest.raises(P.ConfigError):
        tset.group_range("Nope")
    reg = P.FieldRegistry()
    P.register_tracer_fields(reg, tset)
    return (tset.ntracers, tset.names, tset.get_index("Temperature"),
            tset.get_index("Debug3"), tset.get_index("Nope"),
            tset.group_range("Base"), tset.group_range("Debug"),
            base.ntracers, reg.group_members("Tracers"),
            reg.get("Salinity").cf_attrs(), reg.get("Debug1").dim_names,
            [d.name for d in tset.defs()])


def case_errors(P):
    msgs = []
    for call in (lambda: P.abort_error("bad {} of {}", 3, "x"),
                 lambda: P.check_error_abort(False, "failed {}", 7)):
        with pytest.raises(P.OmegaError) as e:
            call()
        msgs.append(str(e.value))
    P.check_error_abort(True, "never")
    return msgs, issubclass(P.ConfigError, P.OmegaError)


def case_timers(P):
    t = P.Timers(level=2, auto_fence=True)
    with t.scope("outer"):
        with t.scope("inner", fence_on=np.zeros(3)):
            pass
        with t.scope("deep", level=3):
            pass
    with t.scope("outer"):
        pass
    report = t.report().splitlines()
    return (dict(t.counts), sorted(t.totals), report[0],
            [ln.split()[:2] for ln in report[1:]])


@pytest.mark.parametrize("case", [case_dimension_registry,
                                  case_field_registry, case_tracer_selection,
                                  case_errors, case_timers],
                         ids=lambda c: c.__name__)
def test_registries(case):
    _both(case)


# ------------------------------------------------------- time manager

def case_no_drift(P):
    cal = P.Calendar(P.CalendarKind.NO_LEAP)
    t0 = P.TimeInstant.from_date(cal, 1, 1, 1)
    t = t0
    for _ in range(1000):
        t = t + P.TimeInterval(seconds=Fraction(1, 3))
    assert (t - t0).seconds == Fraction(1000, 3)
    return str(t), t.elapsed


def case_noleap_dates(P):
    cal = P.Calendar(P.CalendarKind.NO_LEAP)
    t = P.TimeInstant.from_string(cal, "0001-01-01_00:00:00")
    t2 = t + P.TimeInterval.from_units(365, P.TimeUnits.DAYS)
    t3 = P.TimeInstant.from_string(cal, "0004-02-28_00:00:00")
    t4 = t3 + P.TimeInterval.from_units(1, P.TimeUnits.DAYS)
    assert (str(t2), str(t4)) == ("0002-01-01_00:00:00",
                                  "0004-03-01_00:00:00")
    return str(t), str(t2), str(t4), t4.elapsed


def case_gregorian_leap(P):
    cal = P.Calendar(P.CalendarKind.GREGORIAN)
    t = P.TimeInstant.from_string(cal, "0004-02-28_00:00:00")
    t4 = t + P.TimeInterval.from_units(1, P.TimeUnits.DAYS)
    assert str(t4) == "0004-02-29_00:00:00"
    return (str(t4), [cal.is_leap(y) for y in (1900, 1981, 1984, 2000)],
            cal.days_in_month(1900, 2), cal.days_in_month(2000, 2))


def case_360day(P):
    cal = P.Calendar(P.CalendarKind.DAY_360)
    t = P.TimeInstant.from_string(cal, "0001-01-30_00:00:00")
    t2 = t + P.TimeInterval.from_units(1, P.TimeUnits.DAYS)
    assert str(t2) == "0001-02-01_00:00:00"
    return str(t2), cal.days_in_year(1), cal.days_to_date(1000)


def case_interval_parse(P):
    out = [P.TimeInterval.from_string(s).total_seconds()
           for s in ("0000_00:10:00", "0001_01:00:00", "00:00:30.25",
                     "0010_00:00:00")]
    with pytest.raises(ValueError):
        P.TimeInterval.from_string("ten minutes")
    with pytest.raises(ValueError):
        P.TimeInterval.from_units(1, P.TimeUnits.MONTHS).total_seconds()
    assert out[:2] == [600.0, 90000.0]
    return out


def case_month_interval(P):
    cal = P.Calendar(P.CalendarKind.NO_LEAP)
    t = P.TimeInstant.from_string(cal, "0001-01-31_00:00:00")
    t2 = t + P.TimeInterval.from_units(1, P.TimeUnits.MONTHS)
    t3 = t + P.TimeInterval.from_units(1, P.TimeUnits.YEARS)
    assert (str(t2), str(t3)) == ("0001-02-28_00:00:00",
                                  "0002-01-31_00:00:00")
    return str(t2), str(t3)


def case_alarm_oneshot_and_periodic(P):
    cal = P.Calendar(P.CalendarKind.NO_LEAP)
    start = P.TimeInstant.from_string(cal, "0001-01-01_00:00:00")
    clock = P.Clock(start, P.TimeInterval.from_units(10, P.TimeUnits.MINUTES))
    oneshot = P.Alarm("end", ring_time=start + P.TimeInterval.from_units(
        30, P.TimeUnits.MINUTES))
    periodic = P.Alarm("hist", interval=P.TimeInterval.from_units(
        20, P.TimeUnits.MINUTES), start=start)
    clock.attach_alarm(oneshot)
    clock.attach_alarm(periodic)
    r1, r2 = [], []
    for i in range(6):
        clock.advance()
        if periodic.is_ringing():
            r2.append(i)
            periodic.reset(clock.get_current_time())
        if oneshot.is_ringing():
            r1.append(i)
            oneshot.stop()
    assert r1 == [2] and r2 == [1, 3, 5]
    with pytest.raises(ValueError):
        P.Alarm("bad")
    return r1, r2, str(periodic.next_ring), oneshot.stopped


def case_clock_restart(P):
    cal = P.Calendar(P.CalendarKind.NO_LEAP)
    start = P.TimeInstant.from_string(cal, "0001-01-01_00:00:00")
    clock = P.Clock(start, P.TimeInterval.from_units(1, P.TimeUnits.HOURS))
    clock.set_current(P.TimeInstant.from_string(cal, "0001-06-15_12:00:00"))
    clock.advance()
    assert str(clock.get_current_time()) == "0001-06-15_13:00:00"
    return str(clock.get_current_time()), str(clock.start_time)


def case_seconds_since(P):
    cal = P.Calendar(P.CalendarKind.NO_LEAP)
    a = P.TimeInstant.from_string(cal, "0001-01-01_00:00:00")
    b = P.TimeInstant.from_string(cal, "0001-01-02_06:00:00")
    assert b.seconds_since(a) == 108000.0
    return b.seconds_since(a), (a < b, a <= b, a > b, a >= b)


def case_julian_leap(P):
    cal = P.Calendar(P.CalendarKind.JULIAN)
    greg = P.Calendar(P.CalendarKind.GREGORIAN)
    dj, dg = cal.date_to_days(1900, 3, 1), greg.date_to_days(1900, 3, 1)
    assert dj - dg == 15
    return ([cal.is_leap(y) for y in (1900, 2000, 1901)],
            cal.days_in_month(1900, 2), dj, dg, cal.days_to_date(dj))


def case_gregorian_proleptic(P):
    from datetime import date
    cal = P.Calendar(P.CalendarKind.GREGORIAN)
    out = []
    for (y, m, d) in [(1, 1, 1), (4, 2, 29), (100, 3, 1), (400, 12, 31),
                      (1582, 10, 15), (1900, 2, 28), (2000, 2, 29),
                      (2019, 12, 31), (2020, 1, 1), (9999, 12, 31)]:
        n = cal.date_to_days(y, m, d)
        assert n == date(y, m, d).toordinal() - 1
        assert cal.days_to_date(n) == (y, m, d)
        out.append(n)
    return out


def case_date_roundtrip(P, kind):
    cal = P.Calendar(getattr(P.CalendarKind, kind))
    out = []
    for s in ["0001-01-01_00:00:00", "0645-06-15_12:30:45",
              "1999-12-28_23:59:59", "9999-12-28_06:00:00",
              "10000-01-01_00:00:00", "12345-07-04_01:02:03",
              "0002-03-04_05:06:07.500000"]:
        t = P.TimeInstant.from_string(cal, s)
        assert str(t).endswith(s.split("-", 1)[1])
        assert str(t).split("-")[0] == f"{int(s.split('-')[0]):04d}"
        out.append((str(t), t.elapsed, t.to_date()))
    return out


def case_year_rollover_months(P):
    cal = P.Calendar(P.CalendarKind.NO_LEAP)
    t = P.TimeInstant.from_string(cal, "0001-11-15_00:00:00")
    out = [str(t + P.TimeInterval.from_units(n, P.TimeUnits.MONTHS))
           for n in (2, 14, -12)]
    assert out == ["0002-01-15_00:00:00", "0003-01-15_00:00:00",
                   "0000-11-15_00:00:00"]
    return out


def case_days_across_leap(P):
    greg = P.Calendar(P.CalendarKind.GREGORIAN)
    d = lambda n: P.TimeInterval.from_units(n, P.TimeUnits.DAYS)
    t = P.TimeInstant.from_string(greg, "2019-03-01_00:00:00")
    out = [str(P.TimeInstant.from_string(greg, "2019-12-27_00:00:00")
               + d(10)),
           str(P.TimeInstant.from_string(greg, "2020-02-28_00:00:00")
               + d(1)),
           str(t + d(400)), str(t + d(400) + d(-400)), str(t - d(1))]
    assert out[:4] == ["2020-01-06_00:00:00", "2020-02-29_00:00:00",
                       "2020-04-04_00:00:00", "2019-03-01_00:00:00"]
    return out


def case_negative_intervals(P):
    iv = P.TimeInterval.from_units(-90, P.TimeUnits.MINUTES)
    cal = P.Calendar(P.CalendarKind.NO_LEAP)
    t = P.TimeInstant.from_string(cal, "0002-01-01_00:30:00")
    out = (iv.total_seconds(), (-iv).total_seconds(),
           (3 * iv).total_seconds(), (iv * 2).total_seconds(),
           (iv + P.TimeInterval.from_units(2, P.TimeUnits.HOURS)
            ).total_seconds(), str(t + iv))
    assert out[-1] == "0001-12-31_23:00:00"
    return out


def case_day_only_calendars(P):
    out = []
    for kind in ("JULIAN_DAY", "MOD_JULIAN_DAY", "NO_CALENDAR"):
        cal = P.Calendar(getattr(P.CalendarKind, kind))
        t = P.TimeInstant.from_date(cal, 1, 1, 100, 6, 0, 0)
        assert t.elapsed == Fraction(99 * 86400 + 6 * 3600)
        for call in (lambda: cal.days_in_month(1, 1),
                     lambda: cal.days_in_year(1)):
            with pytest.raises(ValueError):
                call()
        out.append((t.to_date(), str(t)))
    return out


def case_custom_calendar(P):
    cal = P.Calendar.custom((30,) * 10 + (35, 35),
                            seconds_per_day=25 * 3600)
    t = P.TimeInstant.from_date(cal, 2, 11, 34, 24, 0, 0)
    t2 = P.TimeInstant.from_date(cal, 3, 11, 34, 24, 0, 0)
    t4 = (P.TimeInstant.from_date(cal, 1, 12, 35)
          + P.TimeInterval.from_units(1, P.TimeUnits.MONTHS))
    assert t.to_date() == (2, 11, 34, 24, 0, 0)
    assert (t2 - t).seconds == cal.seconds_per_year
    assert t4.to_date()[:3] == (2, 1, 30)
    with pytest.raises(ValueError):
        P.Calendar.custom((30,) * 11)
    return (cal.days_in_year(1), cal.seconds_per_year, t.to_date(),
            t4.to_date(), str(t4))


def case_monthly_alarm(P):
    cal = P.Calendar(P.CalendarKind.NO_LEAP)
    start = P.TimeInstant.from_string(cal, "0001-11-01_00:00:00")
    clock = P.Clock(start, P.TimeInterval.from_units(6, P.TimeUnits.HOURS))
    monthly = P.Alarm("monthly", interval=P.TimeInterval.from_units(
        1, P.TimeUnits.MONTHS), start=start)
    clock.attach_alarm(monthly)
    rings = []
    for _ in range(4 * 31 * 4):
        clock.advance()
        if monthly.is_ringing():
            rings.append(str(clock.get_current_time()))
            monthly.reset(clock.get_current_time())
    assert rings[:4] == ["0001-12-01_00:00:00", "0002-01-01_00:00:00",
                         "0002-02-01_00:00:00", "0002-03-01_00:00:00"]
    return rings


def case_yearly_alarm_catchup(P):
    cal = P.Calendar(P.CalendarKind.GREGORIAN)
    start = P.TimeInstant.from_string(cal, "2000-02-29_00:00:00")
    yearly = P.Alarm("yearly", interval=P.TimeInterval.from_units(
        1, P.TimeUnits.YEARS), start=start)
    clock = P.Clock(start, P.TimeInterval.from_units(1, P.TimeUnits.DAYS))
    clock.attach_alarm(yearly)
    clock.set_current(P.TimeInstant.from_string(cal, "2002-09-01_00:00:00"))
    out = [yearly.is_ringing()]
    yearly.reset(clock.get_current_time())
    out.append(yearly.is_ringing())
    clock.set_current(P.TimeInstant.from_string(cal, "2003-02-27_00:00:00"))
    out.append(yearly.is_ringing())
    clock.advance()
    out.append(yearly.is_ringing())
    assert out == [True, False, False, True]
    return out, str(yearly.next_ring)


def case_long_clock(P):
    cal = P.Calendar(P.CalendarKind.NO_LEAP)
    start = P.TimeInstant.from_string(cal, "0001-01-01_00:00:00")
    clock = P.Clock(start, P.TimeInterval(seconds=Fraction(1, 7)))
    for _ in range(70_000):
        clock.advance()
    assert (clock.get_current_time() - start).seconds == 10_000
    return str(clock.get_current_time())


def case_interval_comparisons(P):
    a = P.TimeInterval.from_units(1, P.TimeUnits.HOURS)
    b = P.TimeInterval.from_units(61, P.TimeUnits.MINUTES)
    out = (a < b, b > a, a == P.TimeInterval(seconds=Fraction(3600)),
           a <= a, P.TimeInterval.from_units(2, P.TimeUnits.YEARS).months)
    assert out[:3] == (True, True, True)
    return out


TIME_CASES = [case_no_drift, case_noleap_dates, case_gregorian_leap,
              case_360day, case_interval_parse, case_month_interval,
              case_alarm_oneshot_and_periodic, case_clock_restart,
              case_seconds_since, case_julian_leap, case_gregorian_proleptic,
              case_year_rollover_months, case_days_across_leap,
              case_negative_intervals, case_day_only_calendars,
              case_custom_calendar, case_monthly_alarm,
              case_yearly_alarm_catchup, case_long_clock,
              case_interval_comparisons]


@pytest.mark.parametrize("case", TIME_CASES, ids=lambda c: c.__name__)
def test_time_manager(case):
    _both(case)


@pytest.mark.parametrize("kind", ["GREGORIAN", "NO_LEAP", "JULIAN",
                                  "DAY_360"])
def test_date_roundtrip_all_calendars(kind):
    _both(case_date_roundtrip, kind)


def test_calendar_cf_names_match():
    assert ({k.name: v for k, v in
             p_infra.time_manager.CALENDAR_CF_NAMES.items()}
            == {k.name: v for k, v in
                j_infra.time_manager.CALENDAR_CF_NAMES.items()})
    assert ([k.value for k in p_infra.CalendarKind]
            == [k.value for k in j_infra.CalendarKind])
