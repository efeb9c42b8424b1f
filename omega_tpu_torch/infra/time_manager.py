"""Exact time manager — drift-free clocks, calendars, and alarms.

Host-side rewrite of the reference's ESMF-derived TimeMgr
(infra/TimeMgr.h:116-807, 4,775 LoC). The reference stores time as 64-bit
whole seconds plus an integer fraction so that millions of steps accumulate
with no roundoff (TimeMgr.h:95-116); Python's arbitrary-precision
`fractions.Fraction` gives the same no-drift guarantee with far less code.

Six classes map 1:1: TimeFrac -> Fraction, Calendar, TimeInstant,
TimeInterval, Alarm, Clock. Calendar kinds cover the reference set
(TimeMgr.h:72-90): Gregorian, No Leap, Julian day, 360 Day, custom, none.
Time runs on the host; device code only ever sees elapsed seconds as a
Python float.

String format matches the reference / MPAS: 'YYYY-MM-DD_hh:mm:ss.ffff'.
"""

from __future__ import annotations

import dataclasses
import enum
import re
from fractions import Fraction
from typing import Optional


class TimeUnits(enum.Enum):
    SECONDS = "seconds"
    MINUTES = "minutes"
    HOURS = "hours"
    DAYS = "days"
    MONTHS = "months"
    YEARS = "years"


_SECONDS_PER = {
    TimeUnits.SECONDS: Fraction(1),
    TimeUnits.MINUTES: Fraction(60),
    TimeUnits.HOURS: Fraction(3600),
    TimeUnits.DAYS: Fraction(86400),
}


class CalendarKind(enum.Enum):
    """The reference's nine supported kinds minus 'Invalid'
    (infra/TimeMgr.h:72-90)."""
    GREGORIAN = "Gregorian"
    NO_LEAP = "No Leap"
    JULIAN = "Julian"
    JULIAN_DAY = "Julian Day"
    MOD_JULIAN_DAY = "Modified Julian Day"
    DAY_360 = "360 Day"
    CUSTOM = "Custom"
    NO_CALENDAR = "No Calendar"


# CF-convention names written to files (TimeMgr.h "CalendarCFName")
CALENDAR_CF_NAMES = {
    CalendarKind.GREGORIAN: "gregorian",
    CalendarKind.NO_LEAP: "noleap",
    CalendarKind.JULIAN: "julian",
    CalendarKind.JULIAN_DAY: "julian_day",
    CalendarKind.MOD_JULIAN_DAY: "modified_julian_day",
    CalendarKind.DAY_360: "360_day",
    CalendarKind.CUSTOM: "custom",
    CalendarKind.NO_CALENDAR: "none",
}

_DAYS_PER_MONTH_NOLEAP = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)
_DAYS_PER_MONTH_360 = (30,) * 12

# kinds with no year/month structure: dates carry only a day count
_DAY_ONLY = (CalendarKind.JULIAN_DAY, CalendarKind.MOD_JULIAN_DAY,
             CalendarKind.NO_CALENDAR)


@dataclasses.dataclass(frozen=True)
class Calendar:
    """Calendar definitions (infra/TimeMgr.h:281).

    Standard kinds derive their month table from the kind; the Custom
    kind (the reference's separate custom constructor,
    TimeMgr.cpp:1239-1262) takes an explicit days-per-month table plus
    seconds per day/year — build one with `Calendar.custom(...)`.
    """
    kind: CalendarKind = CalendarKind.NO_LEAP
    days_per_month: tuple = None       # CUSTOM only; 12 entries
    seconds_per_day: int = 86400
    seconds_per_year: int = None       # CUSTOM only; derived otherwise

    @classmethod
    def custom(cls, days_per_month, seconds_per_day: int = 86400,
               seconds_per_year: Optional[int] = None) -> "Calendar":
        """User-defined fixed-length calendar (TimeMgr.cpp:1239-1262)."""
        dpm = tuple(int(d) for d in days_per_month)
        if len(dpm) != 12:
            raise ValueError("custom calendar needs 12 months")
        if seconds_per_year is None:
            seconds_per_year = sum(dpm) * seconds_per_day
        return cls(kind=CalendarKind.CUSTOM, days_per_month=dpm,
                   seconds_per_day=int(seconds_per_day),
                   seconds_per_year=int(seconds_per_year))

    def is_leap(self, year: int) -> bool:
        """Calendar::isLeapYear (TimeMgr.cpp:1340-1362): Gregorian full
        rule, Julian every 4 years, all others never."""
        if self.kind is CalendarKind.GREGORIAN:
            return year % 4 == 0 and (year % 100 != 0 or year % 400 == 0)
        if self.kind is CalendarKind.JULIAN:
            return year % 4 == 0
        return False

    def days_in_month(self, year: int, month: int) -> int:
        if self.kind is CalendarKind.CUSTOM:
            return self.days_per_month[month - 1]
        if self.kind is CalendarKind.DAY_360:
            return 30
        if self.kind in _DAY_ONLY:
            raise ValueError(f"{self.kind.value} calendar has no months")
        days = _DAYS_PER_MONTH_NOLEAP[month - 1]
        if month == 2 and self.is_leap(year):
            days += 1
        return days

    def days_in_year(self, year: int) -> int:
        if self.kind is CalendarKind.CUSTOM:
            return sum(self.days_per_month)
        if self.kind is CalendarKind.DAY_360:
            return 360
        if self.kind in _DAY_ONLY:
            raise ValueError(f"{self.kind.value} calendar has no years")
        return 366 if self.is_leap(year) else 365

    def date_to_days(self, year: int, month: int, day: int) -> int:
        """Whole days since 0001-01-01 of this calendar (day-only kinds:
        since day 1)."""
        if self.kind in _DAY_ONLY:
            # no month/year structure (TimeMgr.cpp:1192-1196)
            return day - 1
        if self.kind is CalendarKind.DAY_360:
            return (year - 1) * 360 + (month - 1) * 30 + (day - 1)
        if self.kind is CalendarKind.CUSTOM:
            return ((year - 1) * sum(self.days_per_month)
                    + sum(self.days_per_month[:month - 1]) + (day - 1))
        if self.kind is CalendarKind.NO_LEAP:
            ydays = (year - 1) * 365
        elif self.kind is CalendarKind.GREGORIAN:
            y = year - 1
            ydays = y * 365 + y // 4 - y // 100 + y // 400
        elif self.kind is CalendarKind.JULIAN:
            y = year - 1
            ydays = y * 365 + y // 4
        else:
            ydays = (year - 1) * 365
        mdays = sum(self.days_in_month(year, m) for m in range(1, month))
        return ydays + mdays + (day - 1)

    def days_to_date(self, days: int):
        if self.kind in _DAY_ONLY:
            return 1, 1, days + 1
        if self.kind is CalendarKind.DAY_360:
            year = days // 360 + 1
            rem = days % 360
            return year, rem // 30 + 1, rem % 30 + 1
        if self.kind is CalendarKind.CUSTOM:
            dpy = sum(self.days_per_month)
            year = days // dpy + 1
            rem = days % dpy
        elif self.kind is CalendarKind.NO_LEAP:
            year = days // 365 + 1
            rem = days % 365
        else:
            # Gregorian / Julian: seed low, walk year boundaries exactly
            year = max(1, days // 366)
            while self.date_to_days(year + 1, 1, 1) <= days:
                year += 1
            rem = days - self.date_to_days(year, 1, 1)
        month = 1
        while rem >= self.days_in_month(year, month):
            rem -= self.days_in_month(year, month)
            month += 1
        return year, month, rem + 1

    # ---- seconds-based conversions (Calendar::getElapsedTime /
    # getDateTime, TimeMgr.cpp:1366-1900): custom calendars may use a
    # non-86400-second day, so TimeInstant converts through these ----

    def date_to_seconds(self, year, month, day, hour=0, minute=0,
                        second=0) -> Fraction:
        if self.kind is CalendarKind.CUSTOM:
            base = ((year - 1) * self.seconds_per_year
                    + (sum(self.days_per_month[:month - 1]) + day - 1)
                    * self.seconds_per_day)
            return (Fraction(base) + hour * 3600 + minute * 60
                    + Fraction(second))
        days = self.date_to_days(year, month, day)
        return (Fraction(days) * self.seconds_per_day + hour * 3600
                + minute * 60 + Fraction(second))

    def seconds_to_date(self, elapsed: Fraction):
        if self.kind is CalendarKind.CUSTOM:
            yrs, rem = divmod(elapsed, self.seconds_per_year)
            days, rem = divmod(rem, self.seconds_per_day)
            dpy = sum(self.days_per_month)
            # seconds_per_year may exceed the month table's span; clamp
            # the overflow into the last day of the year like the
            # reference's fixed-length inversion
            days = min(int(days), dpy - 1)
            month, d = 1, int(days)
            while d >= self.days_per_month[month - 1]:
                d -= self.days_per_month[month - 1]
                month += 1
            hh, rem = divmod(rem, 3600)
            mm, ss = divmod(rem, 60)
            return int(yrs) + 1, month, d + 1, int(hh), int(mm), ss
        days, rem = divmod(elapsed, self.seconds_per_day)
        y, mo, d = self.days_to_date(int(days))
        hh, rem = divmod(rem, 3600)
        mm, ss = divmod(rem, 60)
        return y, mo, d, int(hh), int(mm), ss


@dataclasses.dataclass(frozen=True, order=True)
class TimeInterval:
    """Exact time interval (infra/TimeMgr.h:433). Either an exact number of
    seconds, or a calendar interval in months/years."""
    seconds: Fraction = Fraction(0)
    months: int = 0

    @classmethod
    def from_units(cls, value, units: TimeUnits) -> "TimeInterval":
        if units in _SECONDS_PER:
            return cls(seconds=Fraction(value) * _SECONDS_PER[units])
        if units is TimeUnits.MONTHS:
            return cls(months=int(value))
        if units is TimeUnits.YEARS:
            return cls(months=12 * int(value))
        raise ValueError(units)

    @classmethod
    def from_string(cls, s: str) -> "TimeInterval":
        """Parse 'DDDD_hh:mm:ss(.f)' like configs/Default.yml TimeStep."""
        m = re.match(r"^(?:(\d+)_)?(\d+):(\d+):(\d+(?:\.\d+)?)$", s.strip())
        if not m:
            raise ValueError(f"bad interval string: {s!r}")
        d = int(m.group(1) or 0)
        sec = (Fraction(d) * 86400 + int(m.group(2)) * 3600
               + int(m.group(3)) * 60 + Fraction(m.group(4)))
        return cls(seconds=sec)

    def total_seconds(self) -> float:
        if self.months:
            raise ValueError("calendar interval has no fixed seconds")
        return float(self.seconds)

    def __add__(self, o: "TimeInterval") -> "TimeInterval":
        return TimeInterval(self.seconds + o.seconds, self.months + o.months)

    def __neg__(self) -> "TimeInterval":
        return TimeInterval(-self.seconds, -self.months)

    def __mul__(self, k) -> "TimeInterval":
        return TimeInterval(self.seconds * Fraction(k), self.months * int(k))

    __rmul__ = __mul__


@dataclasses.dataclass(frozen=True)
class TimeInstant:
    """Exact instant: rational seconds since 0001-01-01_00:00:00 on a
    calendar (infra/TimeMgr.h:596)."""
    calendar: Calendar
    elapsed: Fraction   # seconds since reference epoch, exact

    @classmethod
    def from_date(cls, calendar: Calendar, year: int, month: int, day: int,
                  hour: int = 0, minute: int = 0, second=0) -> "TimeInstant":
        sec = calendar.date_to_seconds(year, month, day, hour, minute,
                                       second)
        return cls(calendar=calendar, elapsed=sec)

    @classmethod
    def from_string(cls, calendar: Calendar, s: str) -> "TimeInstant":
        m = re.match(
            r"^(\d+)-(\d+)-(\d+)[_ ](\d+):(\d+):(\d+(?:\.\d+)?)$", s.strip())
        if not m:
            raise ValueError(f"bad time string: {s!r}")
        return cls.from_date(calendar, int(m.group(1)), int(m.group(2)),
                             int(m.group(3)), int(m.group(4)),
                             int(m.group(5)), Fraction(m.group(6)))

    def to_date(self):
        return self.calendar.seconds_to_date(self.elapsed)

    def __str__(self) -> str:
        y, mo, d, hh, mm, ss = self.to_date()
        si = int(ss)
        frac = ss - si
        base = f"{y:04d}-{mo:02d}-{d:02d}_{hh:02d}:{mm:02d}:{si:02d}"
        if frac:
            base += f"{float(frac):.6f}".lstrip("0")
        return base

    def __add__(self, iv: TimeInterval) -> "TimeInstant":
        if iv.months:
            y, mo, d, hh, mm, ss = self.to_date()
            tot = (mo - 1) + iv.months
            y2, mo2 = y + tot // 12, tot % 12 + 1
            d2 = min(d, self.calendar.days_in_month(y2, mo2))
            base = TimeInstant.from_date(self.calendar, y2, mo2, d2, hh, mm, ss)
            return TimeInstant(self.calendar, base.elapsed + iv.seconds)
        return TimeInstant(self.calendar, self.elapsed + iv.seconds)

    def __sub__(self, o):
        if isinstance(o, TimeInstant):
            return TimeInterval(seconds=self.elapsed - o.elapsed)
        return self + (-o)

    def __lt__(self, o): return self.elapsed < o.elapsed
    def __le__(self, o): return self.elapsed <= o.elapsed
    def __gt__(self, o): return self.elapsed > o.elapsed
    def __ge__(self, o): return self.elapsed >= o.elapsed

    def seconds_since(self, ref: "TimeInstant") -> float:
        return float(self.elapsed - ref.elapsed)


class Alarm:
    """One-shot or periodic alarm (infra/TimeMgr.h:729)."""

    def __init__(self, name: str, ring_time: Optional[TimeInstant] = None,
                 interval: Optional[TimeInterval] = None,
                 start: Optional[TimeInstant] = None):
        if ring_time is None and (interval is None or start is None):
            raise ValueError("alarm needs ring_time or (interval, start)")
        self.name = name
        self.interval = interval
        self.ringing = False
        self.stopped = False
        if interval is not None:
            self.next_ring = start + interval if ring_time is None else ring_time
        else:
            self.next_ring = ring_time

    def is_ringing(self) -> bool:
        return self.ringing

    def reset(self, current: TimeInstant) -> None:
        """Turn off; for periodic alarms schedule the next ring after now."""
        self.ringing = False
        if self.interval is not None:
            while self.next_ring <= current:
                self.next_ring = self.next_ring + self.interval

    def stop(self) -> None:
        self.stopped = True
        self.ringing = False

    def update(self, now: TimeInstant) -> bool:
        if not self.stopped and not self.ringing and now >= self.next_ring:
            self.ringing = True
        return self.ringing


class Clock:
    """Model clock with attached alarms (infra/TimeMgr.h:807)."""

    def __init__(self, start: TimeInstant, step: TimeInterval):
        self.start_time = start
        self.current = start
        self.step = step
        self.alarms: list[Alarm] = []

    def attach_alarm(self, alarm: Alarm) -> None:
        self.alarms.append(alarm)
        alarm.update(self.current)

    def advance(self) -> None:
        self.current = self.current + self.step
        for a in self.alarms:
            a.update(self.current)

    def set_current(self, t: TimeInstant) -> None:
        self.current = t
        for a in self.alarms:
            a.update(self.current)

    def get_current_time(self) -> TimeInstant:
        return self.current
