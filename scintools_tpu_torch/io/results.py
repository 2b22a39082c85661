"""Results CSV I/O — drop-in compatible with the reference schema
(scint_utils.py:103-218)."""

from __future__ import annotations

import csv
import os

import numpy as np

# (attribute, columns) in the reference's exact order
# (scint_utils.py:113-193)
_FIELDS = [
    ("tau", ["tau", "tauerr"]),
    ("dnu", ["dnu", "dnuerr"]),
    ("fse_tau", ["fse_tau", "fse_dnu"]),
    ("scint_param_method", ["scint_param_method"]),
    ("dnu_est", ["dnu_est"]),
    ("nscint", ["nscint"]),
    ("ar", ["ar", "arerr"]),
    ("acf_tilt", ["acf_tilt", "acf_tilt_err"]),
    ("fse_tilt", ["fse_tilt"]),
    ("phasegrad", ["phasegrad", "phasegraderr"]),
    ("fse_phasegrad", ["fse_phasegrad"]),
    ("theta", ["theta", "thetaerr"]),
    ("psi", ["psi", "psierr"]),
    ("eta", ["eta", "etaerr"]),
    ("betaeta", ["betaeta", "betaetaerr"]),
    ("eta_left", ["eta_left", "etaerr_left"]),
    ("betaeta_left", ["betaeta_left", "betaetaerr_left"]),
    ("eta_right", ["eta_right", "etaerr_right"]),
    ("betaeta_right", ["betaeta_right", "betaetaerr_right"]),
    ("norm_delmax", ["delmax"]),
]

_ATTR_FOR_COL = {
    "tauerr": "tauerr", "dnuerr": "dnuerr", "fse_dnu": "fse_dnu",
    "arerr": "arerr", "acf_tilt_err": "acf_tilt_err",
    "phasegraderr": "phasegraderr", "thetaerr": "thetaerr",
    "psierr": "psierr", "etaerr": "etaerr", "betaetaerr": "betaetaerr",
    "etaerr_left": "etaerr_left", "betaetaerr_left": "betaetaerr_left",
    "etaerr_right": "etaerr_right",
    "betaetaerr_right": "betaetaerr_right", "delmax": "norm_delmax",
}


def write_results(filename, dyn=None):
    """Append a results row, writing the header if the file is new
    (scint_utils.py:103-202).

    The write is ATOMIC (full-content temp + rename,
    parallel/checkpoint.py:atomic_write_bytes): a survey killed
    mid-append leaves either the previous intact CSV or the new one,
    never a torn row that poisons every later ``read_results`` of the
    accumulated survey output."""
    header = "name,mjd,freq,bw,tobs,dt,df"
    row = (f"{dyn.name},{dyn.mjd},{dyn.freq},{dyn.bw},{dyn.tobs},"
           f"{dyn.dt},{dyn.df}")
    for attr, cols in _FIELDS:
        if not hasattr(dyn, attr):
            continue
        header += "," + ",".join(cols)
        vals = []
        for col in cols:
            a = _ATTR_FOR_COL.get(col, col)
            vals.append(str(getattr(dyn, a, None)))
        row += "," + ",".join(vals)
    from ..parallel.checkpoint import atomic_write_bytes

    existing = b""
    if os.path.exists(filename) and os.stat(filename).st_size > 0:
        with open(filename, "rb") as fh:
            existing = fh.read()
    if not existing:
        existing = (header + "\n").encode()
    atomic_write_bytes(filename, existing + (row + "\n").encode())


def read_results(filename):
    """CSV → dict of lists (scint_utils.py:205-218)."""
    with open(filename, "r") as fh:
        data = list(csv.reader(fh, delimiter=","))
    keys = data[0]
    out = {k: [] for k in keys}
    for row in data[1:]:
        for i, val in enumerate(row):
            out[keys[i]].append(val)
    return out


def float_array_from_dict(dictionary, key):
    """dict column → float array, 'None' → nan
    (scint_utils.py:245-257)."""
    arr = ["nan" if v == "None" else v for v in dictionary[key]]
    return np.array(list(map(float, arr))).squeeze()


def read_dynlist(file_path):
    """List of dynspec filenames from a text file
    (scint_utils.py:94-100)."""
    with open(file_path) as fh:
        return fh.read().splitlines()
