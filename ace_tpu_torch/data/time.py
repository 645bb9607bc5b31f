"""Calendar-aware time coordinates (cftime replacement).

The reference carries cftime DataArrays alongside batches
(fme/ace/data_loading/batch_data.py) and computes orbital insolation from
calendar components (fme/ace/stepper/insolation/). cftime is not available
here, so this module implements the three calendars ACE datasets use:

- "proleptic_gregorian" / "standard": via numpy datetime64 arithmetic
- "noleap" (365_day): fixed 365-day years
- "julian": leap every 4 years
- "360_day": twelve 30-day months
- "all_leap" (366_day): every year has 366 days

A TimeCoord is (calendar, int64 microseconds since 0001-01-01 00:00:00 of
that calendar) — vectorized numpy throughout.

A copy of ``ace_tpu/data/time.py`` (numpy on the host; tests hold it equal to
the original).
"""

import dataclasses

import numpy as np

_DAYS_PER_MONTH = np.asarray(
    [31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31], dtype=np.int64
)
_CUM_DAYS = np.concatenate([[0], np.cumsum(_DAYS_PER_MONTH)])

MICROS_PER_DAY = 86400 * 10**6
MICROS_PER_SECOND = 10**6


def _is_leap(year, calendar: str):
    year = np.asarray(year)
    if calendar in ("noleap", "365_day", "360_day"):
        return np.zeros(year.shape, dtype=bool)
    if calendar in ("all_leap", "366_day"):
        return np.ones(year.shape, dtype=bool)
    if calendar == "julian":
        return year % 4 == 0
    # proleptic gregorian
    return (year % 4 == 0) & ((year % 100 != 0) | (year % 400 == 0))


def _days_in_year(year, calendar: str):
    if calendar == "360_day":
        return np.full(np.asarray(year).shape, 360, dtype=np.int64)
    return np.where(_is_leap(year, calendar), 366, 365).astype(np.int64)


def _days_before_year(year, calendar: str):
    """Days from 0001-01-01 to Jan 1 of `year` (year >= 1)."""
    y = np.asarray(year).astype(np.int64) - 1
    if calendar in ("noleap", "365_day"):
        return y * 365
    if calendar == "360_day":
        return y * 360
    if calendar in ("all_leap", "366_day"):
        return y * 366
    if calendar == "julian":
        return y * 365 + y // 4
    return y * 365 + y // 4 - y // 100 + y // 400


def _ymd_to_day_number(year, month, day, calendar: str):
    month = np.asarray(month).astype(np.int64)
    day = np.asarray(day).astype(np.int64)
    if calendar == "360_day":
        doy = (month - 1) * 30 + (day - 1)
        return _days_before_year(year, calendar) + doy
    doy = _CUM_DAYS[month - 1] + (day - 1)
    leap_adjust = ((month > 2) & _is_leap(year, calendar)).astype(np.int64)
    return _days_before_year(year, calendar) + doy + leap_adjust


def encode_time(year, month, day, hour=0, minute=0, second=0,
                calendar: str = "proleptic_gregorian") -> np.ndarray:
    """Encode calendar components to int64 microseconds since 0001-01-01."""
    days = _ymd_to_day_number(year, month, day, calendar)
    micros = (
        days * MICROS_PER_DAY
        + (np.asarray(hour).astype(np.int64) * 3600
           + np.asarray(minute).astype(np.int64) * 60
           + np.asarray(second).astype(np.int64)) * MICROS_PER_SECOND
    )
    return micros


def decode_time(micros, calendar: str = "proleptic_gregorian"):
    """Decode to dict of integer component arrays
    (year, month, day, hour, minute, second, day_of_year [1-based]).
    """
    micros = np.asarray(micros).astype(np.int64)
    days = micros // MICROS_PER_DAY
    rem = micros - days * MICROS_PER_DAY
    second_of_day = rem // MICROS_PER_SECOND

    # find year by estimate + correction
    year = days // 366 + 1
    while True:
        next_start = _days_before_year(year + 1, calendar)
        too_small = next_start <= days
        if not np.any(too_small):
            break
        year = year + too_small.astype(np.int64)
    day_of_year = days - _days_before_year(year, calendar)  # 0-based

    if calendar == "360_day":
        month = day_of_year // 30 + 1
        day = day_of_year % 30 + 1
    else:
        leap = _is_leap(year, calendar)
        cum = np.broadcast_to(_CUM_DAYS, (*year.shape, 13)).copy()
        # months from March on start one day later in leap years
        cum[..., 2:] += leap[..., None].astype(np.int64)
        month = (day_of_year[..., None] >= cum).sum(axis=-1).astype(np.int64)
        day = day_of_year - np.take_along_axis(
            cum, month[..., None] - 1, axis=-1
        )[..., 0] + 1
    hour = second_of_day // 3600
    minute = (second_of_day % 3600) // 60
    second = second_of_day % 60
    return {
        "year": year, "month": month, "day": day,
        "hour": hour, "minute": minute, "second": second,
        "day_of_year": day_of_year + 1,
    }


def fractional_day_of_year(micros, calendar: str = "proleptic_gregorian"):
    """0-based fractional day of year (for orbital calculations)."""
    micros = np.asarray(micros).astype(np.int64)
    comp = decode_time(micros, calendar)
    frac = (micros % MICROS_PER_DAY) / MICROS_PER_DAY
    return (comp["day_of_year"] - 1) + frac


def days_in_year(micros, calendar: str = "proleptic_gregorian"):
    comp = decode_time(micros, calendar)
    return _days_in_year(comp["year"], calendar)


def parse_datetime_string(s: str, calendar: str = "proleptic_gregorian") -> int:
    """Parse 'YYYY-MM-DD[THH:MM[:SS]]' to encoded microseconds."""
    s = s.strip().replace(" ", "T")
    date_part, _, time_part = s.partition("T")
    y, m, d = (int(x) for x in date_part.split("-"))
    hh = mm = ss = 0
    if time_part:
        parts = time_part.split(":")
        hh = int(parts[0])
        if len(parts) > 1:
            mm = int(parts[1])
        if len(parts) > 2:
            ss = int(float(parts[2]))
    return int(encode_time(y, m, d, hh, mm, ss, calendar))


def format_time(micros: int, calendar: str = "proleptic_gregorian") -> str:
    c = decode_time(np.asarray([micros]), calendar)
    return (
        f"{int(c['year'][0]):04d}-{int(c['month'][0]):02d}-"
        f"{int(c['day'][0]):02d}T{int(c['hour'][0]):02d}:"
        f"{int(c['minute'][0]):02d}:{int(c['second'][0]):02d}"
    )


@dataclasses.dataclass
class TimeCoord:
    """A vector of times in a named calendar.

    values: int64 microseconds since 0001-01-01 in `calendar`.
    """

    values: np.ndarray
    calendar: str = "proleptic_gregorian"

    def __post_init__(self):
        self.values = np.asarray(self.values, dtype=np.int64)

    def __len__(self):
        return len(self.values)

    def __getitem__(self, idx) -> "TimeCoord":
        vals = self.values[idx]
        return TimeCoord(np.atleast_1d(vals), self.calendar)

    def components(self) -> dict[str, np.ndarray]:
        return decode_time(self.values, self.calendar)

    def fractional_day_of_year(self) -> np.ndarray:
        return fractional_day_of_year(self.values, self.calendar)

    def days_in_year(self) -> np.ndarray:
        return days_in_year(self.values, self.calendar)

    def second_of_day(self) -> np.ndarray:
        return (self.values % MICROS_PER_DAY) // MICROS_PER_SECOND

    def concat(self, other: "TimeCoord") -> "TimeCoord":
        if other.calendar != self.calendar:
            raise ValueError("cannot concat TimeCoords of different calendars")
        return TimeCoord(
            np.concatenate([self.values, other.values]), self.calendar
        )

    @classmethod
    def from_range(cls, start: str, n: int, step_seconds: int,
                   calendar: str = "proleptic_gregorian") -> "TimeCoord":
        t0 = parse_datetime_string(start, calendar)
        vals = t0 + np.arange(n, dtype=np.int64) * step_seconds * MICROS_PER_SECOND
        return cls(vals, calendar)

    def timestep_seconds(self) -> float:
        diffs = np.diff(self.values)
        if len(diffs) and not np.all(diffs == diffs[0]):
            raise ValueError("time axis is not evenly spaced")
        return float(diffs[0]) / MICROS_PER_SECOND if len(diffs) else 0.0


@dataclasses.dataclass
class TimeSlice:
    """Datetime-string slice of the time axis, stop inclusive
    (reference: fme/core/dataset/time.py:10 TimeSlice). Partial strings
    select at the encoded-microsecond level.
    """

    start_time: str | None = None
    stop_time: str | None = None
    step: int | None = None

    def indices(self, time: "TimeCoord") -> np.ndarray:
        values = np.asarray(time.values)
        lo = 0
        hi = len(values)
        if self.start_time is not None:
            start_us = parse_datetime_string(
                _pad_partial(self.start_time), time.calendar
            )
            lo = int(np.searchsorted(values, start_us, side="left"))
        if self.stop_time is not None:
            # partial stops select through the END of the period: use the
            # first instant of the NEXT period as an exclusive bound so
            # month lengths (incl. February per calendar) are exact
            # (the reference gets this from CFTimeIndex.slice_indexer)
            nxt = _next_period_start(self.stop_time)
            if nxt is not None:
                stop_us = parse_datetime_string(nxt, time.calendar)
                hi = int(np.searchsorted(values, stop_us, side="left"))
            else:
                stop_us = parse_datetime_string(
                    self.stop_time.strip(), time.calendar
                )
                hi = int(np.searchsorted(values, stop_us, side="right"))
        return np.arange(lo, hi, self.step or 1)


def _next_period_start(s: str) -> str | None:
    """First instant after the period a partial time string denotes, or
    None for fully specified timestamps (inclusive semantics)."""
    s = s.strip()
    if len(s) == 4:  # year
        return f"{int(s) + 1:04d}-01-01T00:00:00"
    if len(s) == 7:  # year-month
        year, month = int(s[:4]), int(s[5:7])
        if month == 12:
            return f"{year + 1:04d}-01-01T00:00:00"
        return f"{year:04d}-{month + 1:02d}-01T00:00:00"
    if len(s) == 10:  # date
        # next day via day-number arithmetic is calendar-dependent, but
        # adding 24h in microseconds at parse time is exact; express the
        # bound as the same date's last microsecond instead
        return None if "T" in s else f"{s}T23:59:59.999999"
    return None


def _pad_partial(s: str, end: bool = False) -> str:
    """Expand a partial time string ("2000", "2000-03") to a full
    timestamp at the start of the period (end bounds go through
    _next_period_start)."""
    s = s.strip()
    if len(s) == 4:  # year
        return f"{s}-01-01T00:00:00"
    if len(s) == 7:  # year-month
        return f"{s}-01T00:00:00"
    if len(s) == 10:  # date
        return f"{s}T00:00:00"
    return s


@dataclasses.dataclass
class RepeatedInterval:
    """Boolean-mask subsetting: keep ``interval_length`` steps starting at
    ``start`` within every ``block_length`` block
    (reference: fme/core/dataset/time.py:59 RepeatedInterval). All three
    are ints (steps) or all timedelta strings ("1d", "6h", ...).
    """

    interval_length: int | str
    start: int | str
    block_length: int | str

    def __post_init__(self):
        types = {
            type(self.interval_length), type(self.block_length),
            type(self.start),
        }
        if len(types) > 1:
            raise ValueError(
                "interval_length, start and block_length must be all int "
                "or all str"
            )
        self._is_str = isinstance(self.interval_length, str)

    def get_boolean_mask(self, length: int,
                         timestep=None) -> np.ndarray:
        if self._is_str:
            if timestep is None:
                raise ValueError(
                    "timestep required for timedelta-string intervals"
                )
            import pandas as pd

            def to_steps(v):
                td = pd.Timedelta(v).to_pytimedelta()
                if td % timestep != type(timestep)(0):
                    raise ValueError(
                        f"interval {v} is not a multiple of the "
                        f"timestep {timestep}"
                    )
                return int(td // timestep)

            interval = to_steps(self.interval_length)
            block = to_steps(self.block_length)
            start = to_steps(self.start)
        else:
            interval = self.interval_length
            block = self.block_length
            start = self.start
        if start + interval > block:
            raise ValueError(
                "interval (with start) must fit within the repeat block"
            )
        unit = np.zeros(block, bool)
        unit[start : start + interval] = True
        reps = length // block + 1
        return np.tile(unit, reps)[:length]

    def indices(self, time: "TimeCoord", timestep=None) -> np.ndarray:
        return np.nonzero(
            self.get_boolean_mask(len(time), timestep)
        )[0]
