"""Deterministic fault-injection harness for the survey layer.

The port's own copy of ``scintools_tpu/robust/faults.py``, injector for
injector, so the tests can drive both packages through the same
faults:

- **corrupt pixels** — :func:`inject_nan_pixels`;
- **corrupt epochs** — :func:`inject_neginf_db` (an all-zero
  pass-band turned into −inf by a dB conversion upstream);
- **truncated inputs** — :func:`truncate_chunk_stack` and
  :func:`corrupt_file_tail` (a file whose tail a SIGKILL tore);
- **environment faults** — :func:`tier_failure_hook` /
  :func:`maybe_fail`, a process-wide hook the fallback ladder
  consults before running each tier, so a compile or OOM
  ``RuntimeError`` can be simulated per (tier, epoch, stage) without
  a real device failure;
- **filesystem faults** — :func:`torn_write`,
  :func:`delayed_visibility` / :func:`reveal` and :func:`eio_reads`.

All randomised injectors take an explicit ``seed`` and never touch
global RNG state.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np

# process-wide injection hook consulted by robust/ladder.py before
# each tier attempt: ``hook(tier=..., epoch=..., stage=...)`` — raise
# from it to simulate that tier failing. None → no injection.
TIER_FAIL_HOOK = None


def maybe_fail(tier, epoch=None, stage=None):
    """Consult the process-wide injection hook (no-op when unset).
    The fallback ladder calls this before every tier attempt; a test
    installs a hook (directly or via :func:`tier_failure_hook`) that
    raises e.g. ``RuntimeError('RESOURCE_EXHAUSTED ...')`` to drive
    the ladder down a tier."""
    if TIER_FAIL_HOOK is not None:
        TIER_FAIL_HOOK(tier=tier, epoch=epoch, stage=stage)


@contextlib.contextmanager
def tier_failure_hook(fail_tiers, exc=None, max_failures=None):
    """Context manager installing a deterministic per-tier failure:
    every attempt on a tier named in ``fail_tiers`` raises ``exc``
    (default: a transient-looking compile ``RuntimeError``), up to
    ``max_failures`` injections in total (None = unlimited). Yields
    the mutable list of (tier, epoch, stage) injection records."""
    global TIER_FAIL_HOOK
    if exc is None:
        exc = RuntimeError("XLA compile failed (injected fault)")
    fail_tiers = set(fail_tiers)
    records = []

    def hook(tier=None, epoch=None, stage=None):
        if tier in fail_tiers and (max_failures is None
                                   or len(records) < max_failures):
            records.append((tier, epoch, stage))
            raise exc

    prev = TIER_FAIL_HOOK
    TIER_FAIL_HOOK = hook
    try:
        yield records
    finally:
        TIER_FAIL_HOOK = prev


def inject_nan_pixels(dyn, frac=0.01, seed=0):
    """Copy of ``dyn`` with ``frac`` of its pixels NaN'd at
    deterministic positions (``seed``)."""
    out = np.array(dyn, dtype=float, copy=True)
    rng = np.random.default_rng(seed)
    n = max(1, int(frac * out.size))
    idx = rng.choice(out.size, size=n, replace=False)
    out.flat[idx] = np.nan
    return out


def inject_neginf_db(dyn, rows=None):
    """Copy of ``dyn`` with whole frequency rows at −inf (default:
    every row — the classic dead-epoch signature of ``10·log10(0)``
    from an upstream dB conversion)."""
    out = np.array(dyn, dtype=float, copy=True)
    if rows is None:
        out[:] = -np.inf
    else:
        out[np.asarray(rows)] = -np.inf
    return out


def truncate_chunk_stack(stack, keep):
    """First ``keep`` chunks of a stacked chunk batch — the shape a
    survey sees when a writer died mid-stack. ``keep`` must be ≥ 1
    (an empty stack is a malformed input, not a truncation)."""
    keep = int(keep)
    if keep < 1:
        raise ValueError("truncate_chunk_stack: keep must be >= 1")
    return np.asarray(stack)[:keep]


def corrupt_file_tail(path, drop_bytes=16):
    """Truncate ``drop_bytes`` off the end of a file in place — the
    torn-write state a SIGKILL leaves behind mid-append. Returns the
    new size."""
    size = os.path.getsize(path)
    new = max(0, size - int(drop_bytes))
    with open(path, "rb+") as fh:
        fh.truncate(new)
    return new


# ---------------------------------------------------------------------
# filesystem-fault injectors
# ---------------------------------------------------------------------

def torn_write(path, data, frac=0.5):
    """Write only the first ``frac`` of ``data`` to ``path``,
    NON-atomically — the visible-but-incomplete file a writer that
    died (or hit EIO) mid-``write()`` leaves behind. At least one
    byte is written so the file exists and is non-empty (the
    hard-to-detect shape; a zero-byte file is trivially torn).
    Returns the number of bytes written."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    n = max(1, int(len(data) * float(frac))) if data else 0
    with open(os.fspath(path), "wb") as fh:
        fh.write(data[:n])
    return n


def delayed_visibility(path, suffix=".invisible"):
    """Hide ``path`` from readers by renaming it aside — the
    NFS-style window where a completed rename is not yet visible to
    another client. Returns the hidden path to hand to
    :func:`reveal`. The pair is atomic at each end, so a watcher
    never sees a torn file — only a late one."""
    path = os.fspath(path)
    hidden = path + suffix
    os.replace(path, hidden)
    return hidden


def reveal(hidden, suffix=".invisible"):
    """Complete a :func:`delayed_visibility` window: rename the
    hidden file back into place and return the visible path."""
    hidden = os.fspath(hidden)
    if not hidden.endswith(suffix):
        raise ValueError(f"not a hidden path: {hidden!r}")
    path = hidden[:-len(suffix)]
    os.replace(hidden, path)
    return path


@contextlib.contextmanager
def eio_reads(match, times=1):
    """Patch ``builtins.open`` so the first ``times`` opens of a
    path containing ``match`` raise ``OSError(EIO)`` — a flaky disk
    under a reader. Yields the mutable list of faulted paths; other
    opens pass through untouched."""
    import builtins
    import errno

    real_open = builtins.open
    faulted = []

    def flaky_open(file, *args, **kwargs):
        try:
            name = os.fspath(file)
        except TypeError:
            name = ""
        if (isinstance(name, str) and match in name
                and len(faulted) < int(times)):
            faulted.append(name)
            raise OSError(errno.EIO, "injected EIO", name)
        return real_open(file, *args, **kwargs)

    builtins.open = flaky_open
    try:
        yield faulted
    finally:
        builtins.open = real_open
