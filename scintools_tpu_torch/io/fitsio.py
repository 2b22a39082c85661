"""Minimal FITS primary-HDU image reader and writer (astropy-free,
host numpy).

Counterpart of ``scintools_tpu/io/fitsio.py:1-110``, copied: the simple
files the ``HoloDyn`` adapter reads (primary HDU, BITPIX in
{-64,-32,8,16,32,64}, 2-D data, optional BSCALE/BZERO), the writer and
``save_fits`` (scint_utils.py:260-267). The bytes written are the JAX
package's.
"""

from __future__ import annotations

import numpy as np

_BITPIX_DTYPE = {
    8: ">u1", 16: ">i2", 32: ">i4", 64: ">i8",
    -32: ">f4", -64: ">f8",
}


def _parse_header(fh):
    header = {}
    while True:
        block = fh.read(2880)
        if len(block) < 2880:
            raise ValueError("truncated FITS header")
        for i in range(0, 2880, 80):
            card = block[i:i + 80].decode("ascii", errors="replace")
            key = card[:8].strip()
            if key == "END":
                return header
            if "=" not in card:
                continue
            val = card[9:].split("/")[0].strip()
            try:
                header[key] = int(val)
            except ValueError:
                try:
                    header[key] = float(val)
                except ValueError:
                    header[key] = val.strip("' ")


def read_fits_image(path, survey=False):
    """Read the primary-HDU image of a simple FITS file → ndarray.

    ``survey=True`` maps any parse failure (truncated header or data,
    unsupported BITPIX, missing NAXIS cards) to the epoch-skipping
    :class:`~.psrflux.MalformedInputError` so a
    survey loop quarantines the file instead of dying on an opaque
    KeyError/ValueError."""
    if survey:
        from .psrflux import MalformedInputError

        try:
            return read_fits_image(path, survey=False)
        except (OSError, ValueError, KeyError, IndexError) as e:
            raise MalformedInputError(path, repr(e)) from e
    with open(path, "rb") as fh:
        header = _parse_header(fh)
        bitpix = header["BITPIX"]
        naxis = header["NAXIS"]
        shape = tuple(header[f"NAXIS{i}"]
                      for i in range(naxis, 0, -1))
        count = int(np.prod(shape))
        dtype = np.dtype(_BITPIX_DTYPE[bitpix])
        data = np.frombuffer(fh.read(count * dtype.itemsize),
                             dtype=dtype).reshape(shape)
        data = data.astype(float)
        bscale = header.get("BSCALE", 1.0)
        bzero = header.get("BZERO", 0.0)
        if bscale != 1.0 or bzero != 0.0:
            data = data * bscale + bzero
        return data


def _card(key, value):
    if isinstance(value, bool):
        v = "T" if value else "F"
        return f"{key:<8}= {v:>20}".ljust(80)
    if isinstance(value, (int, float)):
        return f"{key:<8}= {value:>20}".ljust(80)
    return f"{key:<8}= '{value}'".ljust(80)


def write_fits_image(path, data):
    """Write a 2-D float64 array as a simple FITS primary HDU."""
    data = np.asarray(data, dtype=">f8")
    cards = [
        _card("SIMPLE", True),
        _card("BITPIX", -64),
        _card("NAXIS", data.ndim),
    ]
    for i, n in enumerate(reversed(data.shape), start=1):
        cards.append(_card(f"NAXIS{i}", n))
    cards.append("END".ljust(80))
    header = "".join(cards)
    header += " " * (2880 * int(np.ceil(len(header) / 2880))
                     - len(header))
    with open(path, "wb") as fh:
        fh.write(header.encode("ascii"))
        raw = data.tobytes()
        fh.write(raw)
        pad = 2880 * int(np.ceil(len(raw) / 2880)) - len(raw)
        fh.write(b"\x00" * pad)


def save_fits(filename, dyn):
    """Reference save_fits semantics (scint_utils.py:260-267)."""
    write_fits_image(filename,
                     np.flip(np.transpose(np.flip(dyn.dyn, axis=1)),
                             axis=0))
