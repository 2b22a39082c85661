"""lmfit-style parameter container of the fitting layer (host side).

Counterpart of ``scintools_tpu/fit/parameters.py``: the small subset of
lmfit's ``Parameters`` that the fits read (``add``, mapping access,
``value``/``stderr``/``vary``/``min``/``max`` and ``valuesdict()``),
plus :meth:`Parameters.from_state`, which rebuilds a set from plain
data so a parameter set of the JAX package can be carried across.
"""

from __future__ import annotations

import numpy as np


class Parameter:
    __slots__ = ("name", "value", "vary", "min", "max", "stderr")

    def __init__(self, name, value=0.0, vary=True, min=-np.inf, max=np.inf):
        self.name = name
        self.value = value
        self.vary = vary
        self.min = -np.inf if min is None else min
        self.max = np.inf if max is None else max
        self.stderr = None

    def __repr__(self):
        return (f"<Parameter {self.name!r} value={self.value} "
                f"vary={self.vary} bounds=[{self.min}, {self.max}] "
                f"stderr={self.stderr}>")


class Parameters(dict):
    """dict of name → Parameter with lmfit-style helpers."""

    def add(self, name, value=0.0, vary=True, min=-np.inf, max=np.inf):
        self[name] = Parameter(name, value=value, vary=vary, min=min, max=max)
        return self[name]

    def add_many(self, *items):
        """``add(*item)`` for each item, a tuple ``(name, value, vary,
        min, max)`` or any prefix of it."""
        for it in items:
            self.add(*it)

    def valuesdict(self):
        return {k: v.value for k, v in self.items()}

    def copy(self):
        new = Parameters()
        for k, v in self.items():
            p = new.add(k, value=v.value, vary=v.vary, min=v.min, max=v.max)
            p.stderr = v.stderr
        return new

    @classmethod
    def from_state(cls, state):
        """A set from ``{name: (value, vary, min, max, stderr)}``, in the
        mapping's order."""
        new = cls()
        for name, (value, vary, lo, hi, stderr) in state.items():
            new.add(name, value=value, vary=vary, min=lo, max=hi)
            new[name].stderr = stderr
        return new

    def varying_names(self):
        return [k for k, v in self.items() if v.vary]

    def varying_values(self):
        return np.array([self[k].value for k in self.varying_names()],
                        dtype=float)

    def varying_bounds(self):
        names = self.varying_names()
        lo = np.array([self[k].min for k in names], dtype=float)
        hi = np.array([self[k].max for k in names], dtype=float)
        return lo, hi

    def with_values(self, x):
        """A copy with the varying parameters set from the vector ``x``."""
        new = self.copy()
        for name, val in zip(self.varying_names(), np.atleast_1d(x)):
            new[name].value = float(val)
        return new
