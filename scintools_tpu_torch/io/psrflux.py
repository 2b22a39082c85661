"""psrflux-format dynamic-spectrum files, on the host.

The port's own copy of ``scintools_tpu/io/psrflux.py``:
``MalformedInputError`` (:18), ``RawDynSpec`` (:35), ``load_psrflux``
(:87), ``write_psrflux`` (:145) and ``concatenate_time`` (:176). A file
is a ``#``-comment header holding ``MJD0: <mjd>``, then one line per
pixel, ``isub ichan time(min) freq(MHz) flux [flux_err]``. Loading
reshapes the flux to (nsub, nchan), transposes it to (nchan, nsub) and
flips a descending band to ascending frequency. The writer's bytes are
the JAX package's writer's bytes; it writes to a temporary file beside
the target and renames it, so a reader never sees half a file.
"""

from __future__ import annotations

import itertools
import os
from dataclasses import dataclass, field, replace

import numpy as np


class MalformedInputError(ValueError):
    """A dynamic-spectrum file that cannot be parsed (truncated, wrong
    format, inconsistent shape): in survey mode the error that skips the
    epoch. Carries the filename and the parse stage's detail."""

    def __init__(self, filename, detail):
        self.filename = os.fspath(filename) if filename else None
        self.detail = str(detail)
        super().__init__(
            f"malformed dynamic-spectrum input {self.filename!r}: "
            f"{self.detail} — epoch should be skipped in survey mode")


@dataclass
class RawDynSpec:
    """A loaded dynamic spectrum (host numpy): ``dyn`` is (nchan, nsub),
    frequency × time, ascending frequency; times in s from the start,
    freqs in MHz, dt in s, df in MHz."""

    dyn: np.ndarray
    times: np.ndarray
    freqs: np.ndarray
    mjd: float = 60000.0
    name: str = "dynspec"
    header: list = field(default_factory=list)
    filename: str | None = None

    # derived quantities, set in __post_init__ when left None
    dt: float | None = None
    df: float | None = None
    bw: float | None = None
    freq: float | None = None
    tobs: float | None = None

    def __post_init__(self):
        self.dyn = np.asarray(self.dyn)
        self.times = np.asarray(self.times, dtype=float)
        self.freqs = np.asarray(self.freqs, dtype=float)
        if self.dt is None:
            self.dt = (float(np.mean(np.diff(self.times)))
                       if len(self.times) > 1 else 1.0)
        if self.df is None:
            self.df = (float(np.mean(np.diff(self.freqs)))
                       if len(self.freqs) > 1 else 1.0)
        if self.bw is None:
            self.bw = float(self.freqs[-1] - self.freqs[0] + self.df)
        if self.freq is None:
            self.freq = float(round(np.mean(self.freqs), 2))
        if self.tobs is None:
            self.tobs = float(np.max(self.times) + self.dt
                              - np.min(self.times))

    @property
    def nchan(self):
        return self.dyn.shape[0]

    @property
    def nsub(self):
        return self.dyn.shape[1]

    def copy(self, **kwargs):
        out = replace(self, **kwargs) if kwargs else replace(self)
        out.dyn = np.array(out.dyn)
        return out


def load_psrflux(filename, mjd=None, survey=False):
    """Parse a psrflux file into a :class:`RawDynSpec`. With ``survey``
    any parse failure (truncated file, wrong column count, a flux count
    that is not nsub × nchan, non-numeric rows) raises
    :class:`MalformedInputError`; without it the raw exception is
    kept."""
    if survey:
        try:
            return load_psrflux(filename, mjd=mjd, survey=False)
        except MalformedInputError:
            raise
        except (OSError, ValueError, IndexError, KeyError) as e:
            raise MalformedInputError(filename, repr(e)) from e
    head = []
    file_mjd = None
    with open(filename, "r") as fh:
        for line in fh:
            if line.startswith("#"):
                headline = line[1:].strip()
                head.append(headline)
                parts = headline.split()
                if parts and parts[0] == "MJD0:" and file_mjd is None:
                    file_mjd = float(parts[1])
    raw = np.loadtxt(filename).transpose()
    times = np.unique(raw[2] * 60)  # minutes → seconds, leading edges
    if mjd is not None:
        mjd0 = mjd
    else:
        mjd0 = ((file_mjd if file_mjd is not None else 60000.0)
                + times[0] / 86400)
    times = times - times[0]
    freqs = raw[3]
    fluxes = raw[4]
    nchan = int(np.max(raw[1])) + 1
    bw = freqs[-1] - freqs[0]
    df = round(bw / nchan, 5)
    bw = round(bw + df, 2)
    nsub = int(np.max(raw[0])) + 1
    dt = float(np.mean(np.diff(times)))
    tobs = float(np.max(times) + dt)

    freqs = np.unique(freqs)
    fluxes = fluxes.reshape([nsub, nchan]).transpose()
    if df < 0:  # stored descending: flip to ascending frequency
        df, bw = -df, -bw
        fluxes = np.flip(fluxes, 0)

    return RawDynSpec(
        dyn=fluxes, times=times, freqs=freqs, mjd=float(mjd0),
        name=os.path.basename(filename), header=head, filename=filename,
        dt=dt, df=df, bw=float(bw), freq=float(round(np.mean(freqs), 2)),
        tobs=tobs,
    )


_TMP_SEQ = itertools.count()


def _atomic_write_bytes(path, data):
    """Write ``data`` to a temporary file beside ``path`` (named by the
    pid and a per-process counter, so concurrent writers never share
    one), fsync it, then rename it over ``path``."""
    path = os.fspath(path)
    tmp = f"{path}.{os.getpid()}.{next(_TMP_SEQ)}.tmp"
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def write_psrflux(ds, filename, note=None):
    """Write a :class:`RawDynSpec` (or any object with its attributes)
    as a psrflux file with the provenance header, atomically."""
    lines = ["# Scintools-modified dynamic spectrum "
             "in psrflux format",
             "# Created using write_file method in Dynspec class"]
    if note is not None:
        lines.append(f"# Note: {note}")
    lines.append(f"# MJD0: {ds.mjd}")
    lines.append("# Original header begins below:")
    has_isub = False
    for line in ds.header:
        lines.append(f"# {line} ")
        if "isub" in line:
            has_isub = True
    if not has_isub:
        lines.append("# isub ichan time(min) freq(MHz) flux flux_err")
    for i, ti in enumerate(np.asarray(ds.times) / 60):
        for j, fi in enumerate(ds.freqs):
            lines.append(f"{i} {j} {ti} {fi} {ds.dyn[j, i]} {0}")
    _atomic_write_bytes(filename, ("\n".join(lines) + "\n").encode())


def concatenate_time(ds1, ds2):
    """Time-concatenate two dynamic spectra, zero-filling the MJD gap."""
    timegap = round((ds2.mjd - ds1.mjd) * 86400 - ds1.tobs, 1)
    extratimes = np.arange(0, timegap, ds1.dt)
    nextra = 0 if timegap < ds1.dt else len(extratimes)
    gap = np.zeros([ds1.dyn.shape[0], nextra])
    nsub = ds1.nsub + nextra + ds2.nsub
    tobs = ds1.tobs + timegap + ds2.tobs
    times = np.linspace(0, tobs, nsub)
    newdyn = np.concatenate((ds1.dyn, gap, ds2.dyn), axis=1)
    name = (ds1.name.split(".")[0] + "+" + ds2.name.split(".")[0]
            + ".dynspec")
    return RawDynSpec(
        dyn=newdyn, times=times, freqs=ds1.freqs,
        mjd=min(ds1.mjd, ds2.mjd), name=name,
        header=list(ds1.header) + list(ds2.header),
        dt=ds1.dt, df=ds1.df, bw=ds1.bw, freq=ds1.freq, tobs=tobs,
    )
