"""TOA insolation from orbital mechanics, CM4/FMS scheme
(reference: fme/ace/stepper/insolation/cm4.py, itself derived from GFDL
FMS astronomy/time_manager; fme/ace/stepper/derived_forcings.py).

Computes the timestep-averaged downward shortwave flux at TOA for each
(time, lat, lon). Host-side numpy float64 (times are host data; this runs
in the data pipeline, not inside jit), then handed to the device as a
forcing variable.

A copy of ``ace_tpu/stepper/insolation.py`` (numpy on the host; tests hold it equal to
the original), on the port's ``LatLonCoordinates`` and ``data/time.py``.
"""

import dataclasses
import datetime
from typing import Union

import numpy as np

from ace_tpu_torch.core.coordinates import LatLonCoordinates
from ace_tpu_torch.data.time import (
    MICROS_PER_DAY,
    MICROS_PER_SECOND,
    TimeCoord,
    encode_time,
)

AUTUMNAL_EQUINOX = (1998, 9, 23, 5, 37, 0)
NUM_ANGLES = 3600
SECONDS_PER_DAY = 86400

# year lengths per FMS time_manager (reference: cm4.py:207-215)
LENGTH_OF_YEAR_SECONDS = {
    "noleap": 365 * 86400.0,
    "365_day": 365 * 86400.0,
    "standard": 365 * 86400.0 + 20952.0,
    "proleptic_gregorian": 365 * 86400.0 + 20952.0,
    "julian": 365 * 86400.0 + 21600.0,
    "360_day": 360 * 86400.0,
    "all_leap": 366 * 86400.0,
}

MAXIMUM_TIMESTEP = datetime.timedelta(hours=12)


def _r_inv_squared(angle, eccentricity, longitude_of_perhelion):
    rad_per = np.deg2rad(longitude_of_perhelion)
    r = (1 - eccentricity**2) / (1 + eccentricity * np.cos(angle - rad_per))
    return r ** (-2.0)


def _compute_orbital_angle_lookup_table(eccentricity, longitude_of_perhelion):
    """RK4 integration of the orbital angle over one year
    (reference: cm4.py:333).
    """
    table = np.zeros(NUM_ANGLES + 1)
    dt = 2 * np.pi / NUM_ANGLES * np.sqrt(1 - eccentricity**2)
    for i in range(1, NUM_ANGLES + 1):
        prev = table[i - 1]
        d1 = dt * _r_inv_squared(prev, eccentricity, longitude_of_perhelion)
        d2 = dt * _r_inv_squared(
            prev + 0.5 * d1, eccentricity, longitude_of_perhelion
        )
        d3 = dt * _r_inv_squared(
            prev + 0.5 * d2, eccentricity, longitude_of_perhelion
        )
        d4 = dt * _r_inv_squared(prev + d3, eccentricity, longitude_of_perhelion)
        table[i] = prev + d1 / 6.0 + d2 / 3.0 + d3 / 3.0 + d4 / 6.0
    return table


def _orbital_angle(orbital_time, table):
    norm_time = orbital_time * NUM_ANGLES / (2 * np.pi)
    idx = np.floor(norm_time).astype(np.int64) % NUM_ANGLES
    x = norm_time - np.floor(norm_time)
    y = (1.0 - x) * table[idx] + x * table[idx + 1]
    return y % (2 * np.pi)


def _declination(orbital_angle, obliquity):
    return np.arcsin(-np.sin(np.deg2rad(obliquity)) * np.sin(orbital_angle))


def _half_day(lat, declination):
    tan_declination = np.tan(declination)
    lat = np.where(lat == 0.5 * np.pi, lat - 1.0e-5, lat)
    lat = np.where(lat == -0.5 * np.pi, lat + 1.0e-5, lat)
    cos_half_day = -np.tan(lat) * tan_declination
    h = np.where(
        (cos_half_day > -1.0) & (cos_half_day < 1.0),
        np.arccos(np.clip(cos_half_day, -1.0, 1.0)),
        0.0,
    )
    h = np.where(cos_half_day <= -1.0, np.pi, h)
    h = np.where(cos_half_day >= 1.0, 0.0, h)
    return h


class CM4Insolation:
    """Timestep-averaged insolation (reference: cm4.py:221)."""

    def __init__(self, obliquity: float, eccentricity: float,
                 longitude_of_perhelion: float):
        self.obliquity = obliquity
        self.eccentricity = eccentricity
        self.longitude_of_perhelion = longitude_of_perhelion
        self._table = _compute_orbital_angle_lookup_table(
            eccentricity, longitude_of_perhelion
        )

    def __call__(
        self,
        time: TimeCoord,
        timestep: datetime.timedelta,
        coords: LatLonCoordinates,
        solar_constant: Union[float, np.ndarray],
    ) -> np.ndarray:
        """Returns insolation [*time.shape, nlat, nlon] (float64->float32)."""
        if timestep >= MAXIMUM_TIMESTEP:
            raise NotImplementedError(
                "CM4 insolation supports timesteps < 12 hours, got "
                f"{timestep!r}"
            )
        # interval average ending at `time` -> CM4 wants interval start
        t_micro = time.values - int(timestep.total_seconds()) * MICROS_PER_SECOND
        calendar = time.calendar
        eq = int(encode_time(
            np.asarray([AUTUMNAL_EQUINOX[0]]), AUTUMNAL_EQUINOX[1],
            AUTUMNAL_EQUINOX[2], AUTUMNAL_EQUINOX[3], AUTUMNAL_EQUINOX[4],
            AUTUMNAL_EQUINOX[5], calendar=calendar,
        )[0])
        year_len = LENGTH_OF_YEAR_SECONDS[calendar]
        tfrac = (t_micro - eq) / (year_len * MICROS_PER_SECOND)
        orbital_time = 2 * np.pi * (tfrac - np.floor(tfrac))
        universal_time = 2 * np.pi * (
            (t_micro % MICROS_PER_DAY) / MICROS_PER_DAY
        )

        lat = np.deg2rad(np.asarray(coords.lat, dtype=np.float64))
        lon = np.deg2rad(np.asarray(coords.lon, dtype=np.float64))
        lat2d = lat[:, None] * np.ones((1, len(lon)))
        lon2d = np.ones((len(lat), 1)) * lon[None, :]
        # broadcast: time leading dims, then (lat, lon)
        extra = (1,) * (len(lat2d.shape))
        ot = np.reshape(orbital_time, (*orbital_time.shape, *extra))
        ut = np.reshape(universal_time, (*universal_time.shape, *extra))

        orbital_angle = _orbital_angle(ot, self._table)
        declination = _declination(orbital_angle, self.obliquity)
        rrsun = _r_inv_squared(
            orbital_angle, self.eccentricity, self.longitude_of_perhelion
        )

        aa = np.sin(lat2d) * np.sin(declination)
        bb = np.cos(lat2d) * np.cos(declination)

        t = ut + lon2d - np.pi
        t = np.where(t >= np.pi, t - 2 * np.pi, t)
        t = np.where(t < -np.pi, t + 2 * np.pi, t)

        h = _half_day(lat2d, declination)
        dt = 2 * np.pi * timestep.total_seconds() / SECONDS_PER_DAY

        tt = t + dt
        st, stt, sh = np.sin(t), np.sin(tt), np.sin(h)
        with np.errstate(divide="ignore", invalid="ignore"):
            cosz = np.zeros(np.broadcast_shapes(t.shape, h.shape))
            cosz = np.where((t < -h) & (tt < -h), 0.0, cosz)
            cosz = np.where(
                ((tt + h) != 0.0) & (t < -h) & (np.abs(tt) <= h),
                aa + bb * (stt + sh) / np.where((tt + h) == 0, 1, tt + h),
                cosz,
            )
            cosz = np.where(
                (t < -h) & (h != 0.0) & (h < tt),
                aa + bb * (sh + sh) / np.where(h == 0, 1, h + h),
                cosz,
            )
            cosz = np.where(
                (np.abs(t) <= h) & (np.abs(tt) <= h),
                aa + bb * (stt - st) / np.where(tt == t, 1, tt - t),
                cosz,
            )
            cosz = np.where(
                ((h - t) != 0.0) & (np.abs(t) <= h) & (h < tt),
                aa + bb * (sh - st) / np.where(h == t, 1, h - t),
                cosz,
            )
            cosz = np.where(
                ((2 * np.pi - h) < tt) & ((tt + h - 2 * np.pi) != 0.0)
                & (t <= h),
                (cosz * (h - t) + aa * (tt + h - 2 * np.pi) + bb * (stt + sh))
                / np.where(
                    ((h - t) + (tt + h - 2 * np.pi)) == 0,
                    1,
                    (h - t) + (tt + h - 2 * np.pi),
                ),
                cosz,
            )
            cosz = np.where((h < t) & ((2 * np.pi - h) >= tt), 0.0, cosz)
            cosz = np.where(
                (h < t) & ((2 * np.pi - h) < tt),
                aa + bb * (stt + sh) / np.where(
                    (tt + h - 2 * np.pi) == 0, 1, tt + h - 2 * np.pi
                ),
                cosz,
            )
        cosz = np.maximum(0.0, cosz)

        fracday = np.zeros_like(cosz)
        fracday = np.where(
            (t < -h) & (np.abs(tt) <= h), (tt + h) / dt, fracday
        )
        fracday = np.where((t < -h) & (h < tt), (h + h) / dt, fracday)
        fracday = np.where(
            (np.abs(t) <= h) & (np.abs(tt) <= h), (tt - t) / dt, fracday
        )
        fracday = np.where((np.abs(t) <= h) & (h < tt), (h - t) / dt, fracday)
        fracday = np.where(h < t, 0.0, fracday)
        fracday = np.where(
            (2 * np.pi - h) < tt, fracday + (tt + h - 2 * np.pi) / dt, fracday
        )

        insolation = np.asarray(solar_constant) * rrsun * fracday * cosz
        return insolation.astype(np.float32)


@dataclasses.dataclass
class InsolationConfig:
    """Insolation derived-forcing config
    (reference: fme/ace/stepper/insolation/config.py).
    """

    insolation_name: str
    solar_constant_value: float | None = 1360.78
    solar_constant_name: str | None = None
    obliquity: float = 23.439
    eccentricity: float = 0.0167
    longitude_of_perhelion: float = 102.932

    def build(self, timestep, horizontal_coordinates) -> "InsolationDeriver":
        return InsolationDeriver(
            name=self.insolation_name,
            model=CM4Insolation(
                self.obliquity, self.eccentricity, self.longitude_of_perhelion
            ),
            timestep=timestep,
            coords=horizontal_coordinates,
            solar_constant_value=self.solar_constant_value,
            solar_constant_name=self.solar_constant_name,
        )


@dataclasses.dataclass
class InsolationDeriver:
    name: str
    model: CM4Insolation
    timestep: datetime.timedelta
    coords: LatLonCoordinates
    solar_constant_value: float | None
    solar_constant_name: str | None

    def compute(self, time: TimeCoord, data: dict) -> dict:
        # always overwrite: the configured orbital parameters define the
        # forcing even when the dataset stores an insolation variable
        # (the reference removes the name from the data requirements and
        # computes it unconditionally)
        if self.solar_constant_name is not None:
            solar_constant = np.asarray(data[self.solar_constant_name])
        else:
            solar_constant = self.solar_constant_value
        out = dict(data)
        out[self.name] = self.model(
            time, self.timestep, self.coords, solar_constant
        )
        return out


@dataclasses.dataclass
class DerivedForcingsConfig:
    """Derived forcing computation (reference:
    fme/ace/stepper/derived_forcings.py:10).
    """

    insolation: InsolationConfig | None = None

    def build(self, dataset_info) -> "ForcingDeriver":
        deriver = None
        if self.insolation is not None:
            deriver = self.insolation.build(
                dataset_info.timestep, dataset_info.horizontal_coordinates
            )
        return ForcingDeriver(deriver)


class ForcingDeriver:
    def __init__(self, insolation: InsolationDeriver | None):
        self.insolation = insolation

    @property
    def provided_names(self) -> list[str]:
        """Forcing names this deriver supplies — removed from what the
        dataset must provide (reference update_requirements)."""
        return [self.insolation.name] if self.insolation else []

    def __call__(self, time: TimeCoord, data: dict) -> dict:
        if self.insolation is not None:
            return self.insolation.compute(time, data)
        return dict(data)
