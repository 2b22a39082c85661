"""tempo2 ``.par`` pulsar-parameter files (host side).

The port's own copy of ``read_par``, ``_hms_to_rad``, ``_dms_to_rad``
and ``pars_to_params`` of ``scintools_tpu/io/parfile.py:20-97``: each
parameter gets a value, an optional ``<name>_ERR`` and a
``<name>_TYPE`` ('d' int, 'f' float, 'e' scientific, 's' string);
``pars_to_params`` returns the port's ``fit.parameters.Parameters``.
"""

from __future__ import annotations

from decimal import Decimal, InvalidOperation

import numpy as np

IGNORE = ['DMMODEL', 'DMOFF', 'DM_', 'CM_', 'CONSTRAIN', 'JUMP', 'NITS',
          'NTOA', 'CORRECT_TROPOSPHERE', 'PLANET_SHAPIRO', 'DILATEFREQ',
          'TIMEEPH', 'MODE', 'TZRMJD', 'TZRSITE', 'TZRFRQ', 'EPHVER',
          'T2CMETHOD']


def read_par(parfile):
    """Read a .par file → dict of parameter names and values."""
    par = {}
    with open(parfile, "r") as fh:
        for line in fh.readlines():
            err = None
            p_type = None
            sline = line.split()
            if (len(sline) == 0 or line[0] == "#" or line[0:2] == "C "
                    or sline[0] in IGNORE):
                continue
            param = sline[0]
            if param == "E":
                param = "ECC"
            val = sline[1]
            if len(sline) == 3 and sline[2] not in ['0', '1']:
                err = sline[2].replace('D', 'E')
            elif len(sline) == 4:
                err = sline[3].replace('D', 'E')
            try:
                val = int(val)
                p_type = 'd'
            except ValueError:
                try:
                    val = float(Decimal(val.replace('D', 'E')))
                    if 'e' in sline[1] or 'E' in sline[1].replace('D', 'E'):
                        p_type = 'e'
                    else:
                        p_type = 'f'
                except InvalidOperation:
                    p_type = 's'
            par[param] = val
            if err:
                par[param + "_ERR"] = float(err)
            if p_type:
                par[param + "_TYPE"] = p_type
    return par


def _sexagesimal(s):
    parts = [float(p) for p in str(s).split(":")]
    while len(parts) < 3:
        parts.append(0.0)
    a, m, sec = parts[:3]
    sign = -1.0 if str(s).strip().startswith("-") else 1.0
    return sign * (abs(a) + m / 60 + sec / 3600)


def _hms_to_rad(s):
    """'hh:mm:ss.s' hour-angle string → radians."""
    return _sexagesimal(s) * np.pi / 12


def _dms_to_rad(s):
    """'dd:mm:ss.s' degree string → radians."""
    return _sexagesimal(s) * np.pi / 180


def pars_to_params(pars, params=None):
    """A :func:`read_par` dict as a fitting ``Parameters`` set (RAJ and
    DECJ in radians, strings dropped), every parameter with
    ``vary=False``."""
    from ..fit.parameters import Parameters

    if params is None:
        params = Parameters()
    for key, value in pars.items():
        if key in ("RAJ", "RA"):
            params.add("RAJ", value=_hms_to_rad(pars["RAJ"]), vary=False)
            params.add("DECJ", value=_dms_to_rad(pars["DECJ"]), vary=False)
            continue
        if isinstance(value, str):
            continue
        params.add(key, value=value, vary=False)
    return params
