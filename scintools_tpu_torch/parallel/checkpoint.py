"""Checkpoint/resume for long survey runs.

The port's own copy of ``scintools_tpu/parallel/checkpoint.py``:

- :func:`atomic_write_bytes` / :func:`atomic_write_json` —
  write-temp-then-rename, fsynced;
- :class:`EpochJournal` — the append-only, CRC-stamped per-epoch
  journal. :meth:`EpochJournal.format_line` gives the same bytes as
  the JAX package's for the same record, so a journal either package
  wrote resumes in the other;
- :class:`SurveyCheckpointer` — periodic state checkpoints with
  keep-last-k retention, saved by ``torch.save`` under the same atomic
  protocol and CRC stamps the JAX package wraps around orbax;
- :func:`run_survey_with_checkpoints` and :func:`results_state`;
- :func:`initialize_distributed` — the process group that a mesh
  across processes (``parallel/mesh.py``) runs on.
"""

from __future__ import annotations

import itertools
import json
import os
import warnings
import zlib

import numpy as np


def atomic_write_bytes(path, data):
    """Write ``data`` to ``path`` via write-temp-then-rename in the
    same directory (``os.replace`` is atomic on POSIX), fsyncing the
    temp file first — a reader (or a resume after SIGKILL) sees
    either the old file or the complete new one, never a torn
    write.

    The temp name is unique per process (pid + counter): with a
    shared temp name, one writer's ``os.replace`` of a multi-writer
    path could whisk away another's temp file mid-flight. With unique
    temps, concurrent writers are last-write-wins."""
    path = os.fspath(path)
    tmp = f"{path}.{os.getpid()}.{next(_TMP_SEQ)}.tmp"
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


#: per-process temp-file sequence — ``next()`` on an itertools.count
#: is atomic under the GIL, so in-process concurrent writers of one
#: path get distinct temps; the pid prefix separates processes
_TMP_SEQ = itertools.count(1)


def atomic_write_json(path, obj):
    """Atomic JSON dump (see :func:`atomic_write_bytes`)."""
    atomic_write_bytes(path, json.dumps(obj).encode())


def _line_crc(payload):
    """CRC32 of a journal record's JSON payload (sans the crc field
    itself), as zero-padded hex."""
    return f"{zlib.crc32(payload.encode()):08x}"


class EpochJournal:
    """Append-only per-epoch completion journal (JSONL + CRC32).

    One line per completed epoch: ``{"epoch": id, ..., "crc": hex}``
    where ``crc`` covers the rest of the record. Appends are flushed
    and fsynced, so a SIGKILL loses at most the in-flight epoch; the
    reader skips a torn/corrupt tail line (and warns) instead of
    refusing the whole journal. A resumed survey takes every journaled
    record verbatim — re-running only unfinished epochs — which is
    what makes an interrupted run's results identical to an
    uninterrupted one.

    >>> j = EpochJournal(dir / "journal.jsonl")
    >>> done = j.records()                    # {} on fresh start
    >>> for epoch in epochs:
    ...     if epoch.id in done:
    ...         continue                      # resume: trust journal
    ...     j.append(epoch.id, result=process(epoch))
    """

    def __init__(self, path):
        self.path = os.fspath(path)
        parent = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(parent, exist_ok=True)

    @staticmethod
    def format_line(epoch, **fields):
        """The exact journal line (sans newline) :meth:`append` writes
        for a record — the ONE formatting definition, shared with the
        threaded writer (parallel/pipeline.py:AsyncJournalWriter) so a
        pipelined run's journal is byte-identical to a sequential
        one's."""
        rec = {"epoch": epoch, **fields}
        payload = json.dumps(rec, default=str)
        return json.dumps({**rec, "crc": _line_crc(payload)},
                          default=str)

    def append(self, epoch, **fields):
        """Durably journal one completed epoch (flush + fsync)."""
        from ..obs import metrics as _metrics

        line = self.format_line(epoch, **fields)
        with open(self.path, "a") as fh:
            fh.write(line + "\n")
            fh.flush()
            os.fsync(fh.fileno())
        _metrics.counter(
            "survey_journal_bytes_total",
            help="bytes appended to the epoch journal",
        ).inc(len(line.encode()) + 1)
        _metrics.counter(
            "survey_journal_fsyncs_total",
            help="journal fsync barriers taken",
        ).inc()

    def _scan(self):
        """Yield ``(raw_line, record)`` for every intact journaled
        line in append order; corrupt/torn lines are skipped with a
        warning, a missing file is an empty journal."""
        if not os.path.exists(self.path):
            return
        with open(self.path) as fh:
            for i, raw in enumerate(fh):
                line = raw.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                    crc = rec.pop("crc")
                    if crc != _line_crc(json.dumps(rec, default=str)):
                        raise ValueError("crc mismatch")
                except (ValueError, KeyError, TypeError) as e:
                    warnings.warn(
                        f"journal {self.path}: skipping corrupt line "
                        f"{i + 1} ({e})", stacklevel=3)
                    continue
                yield line, rec

    def records(self):
        """``{epoch_id: record}`` for every intact journaled line
        (see :meth:`_scan` for the corrupt-line tolerance)."""
        return {rec["epoch"]: rec for _, rec in self._scan()}

    def iter_records(self):
        """Every intact record (crc verified and stripped) in append
        order — unlike :meth:`records` duplicates are preserved (a
        journal merge resolves duplicate records
        first-committed-wins)."""
        return [rec for _, rec in self._scan()]

    def valid_lines(self):
        """The intact raw journal lines (sans newline) in append
        order — the ATOMIC read view of the journal as a results
        store: a reader sees only complete, CRC-verified
        records, never a torn tail a concurrent writer (or a SIGKILL)
        left behind. Two stores are byte-consistent when their
        valid_lines match."""
        return [line for line, _ in self._scan()]

    def __contains__(self, epoch):
        return epoch in self.records()

    def __len__(self):
        return len(self.records())


class SurveyCheckpointer:
    """Periodic state checkpointing with keep-last-k retention.

    Checkpoints are written *after* a step is processed, so a resume
    continues at ``latest_step() + 1``:

    >>> ckpt = SurveyCheckpointer(dir, every=50, keep=3)
    >>> last = ckpt.latest_step()            # None on fresh start
    >>> state = init if last is None else ckpt.restore(last)
    >>> for step in range(0 if last is None else last + 1, n_epochs):
    ...     state = process(state)
    ...     ckpt.maybe_save(step, state)

    The state (a nest of dicts/lists of numpy arrays, tensors and
    scalars) is saved by ``torch.save`` into ``<dir>/<step>/state.pt``,
    its numpy leaves carried as tagged tensors, and restored with
    ``torch.load(weights_only=True)``: a checkpoint directory copied in
    from elsewhere can hold only tensors, containers and scalars, never
    an object whose unpickling runs code.
    A step directory is written under a temporary name and renamed
    into place, so a step either exists complete or not at all; each
    save is then stamped with a CRC32 + size manifest of the step's
    files (written atomically OUTSIDE the step dir), and restore
    verifies the stamp before trusting a step — bit rot, a partial
    copy or a truncated file is detected instead of loading garbage.
    """

    STATE_FILE = "state.pt"

    def __init__(self, directory, every=50, keep=3):
        self._dir = os.path.abspath(str(directory))
        self.every = int(every)
        self.keep = int(keep)
        os.makedirs(self._dir, exist_ok=True)

    def all_steps(self):
        """Every complete step on disk, ascending."""
        return sorted(int(n) for n in os.listdir(self._dir)
                      if n.isdigit()
                      and os.path.isdir(os.path.join(self._dir, n)))

    def latest_step(self):
        """Step of the newest checkpoint, or None."""
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _step_dir(self, step):
        return os.path.join(self._dir, str(int(step)))

    def _stamp_path(self, step):
        return os.path.join(self._dir, "stamps", f"{int(step)}.json")

    def _step_manifest(self, step):
        root = self._step_dir(step)
        files = {}
        for base, _, names in sorted(os.walk(root)):
            for name in sorted(names):
                p = os.path.join(base, name)
                with open(p, "rb") as fh:
                    data = fh.read()
                files[os.path.relpath(p, root)] = {
                    "bytes": len(data),
                    "crc": f"{zlib.crc32(data):08x}"}
        return {"step": int(step), "files": files}

    def _write_stamp(self, step):
        os.makedirs(os.path.join(self._dir, "stamps"), exist_ok=True)
        atomic_write_json(self._stamp_path(step),
                          self._step_manifest(step))

    def verify_stamp(self, step):
        """Check the CRC/size stamp of ``step``'s files. Returns True
        (intact), False (mismatch/corrupt), or None (no stamp)."""
        path = self._stamp_path(step)
        if not os.path.exists(path):
            return None
        try:
            with open(path) as fh:
                stamp = json.load(fh)
            return (stamp.get("files")
                    == self._step_manifest(step)["files"])
        except (OSError, ValueError):
            return False

    def save(self, step, state, force=True):
        """Write ``state`` as step ``step`` (replacing an existing
        step only when ``force``), stamp it, and drop all but the
        newest ``keep`` steps."""
        import shutil

        import torch

        final = self._step_dir(step)
        if os.path.exists(final):
            if not force:
                return
            shutil.rmtree(final)
        tmp = f"{final}.{os.getpid()}.{next(_TMP_SEQ)}.tmp"
        os.makedirs(tmp)
        with open(os.path.join(tmp, self.STATE_FILE), "wb") as fh:
            torch.save(_encode(state), fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, final)
        self._write_stamp(step)
        for old in self.all_steps()[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)
            try:
                os.remove(self._stamp_path(old))
            except OSError:
                pass

    def maybe_save(self, step, state):
        """Save when ``step`` hits the cadence; returns True if saved."""
        if (int(step) + 1) % self.every == 0:
            self.save(step, state)
            return True
        return False

    def _restore_one(self, step, template):
        import torch

        with open(os.path.join(self._step_dir(step), self.STATE_FILE),
                  "rb") as fh:
            state = _decode(torch.load(fh, weights_only=True))
        return state if template is None else _like(state, template)

    def restore(self, step=None, template=None):
        """Restore the state at ``step`` (default: newest). With
        ``template`` the restored leaves adopt its structure/dtypes.

        When the NEWEST checkpoint is corrupt (stamp mismatch or a
        load error), restore falls back to the next-older step with a
        warning instead of crashing the resume. An explicitly
        requested ``step`` never falls back."""
        explicit = step is not None
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self._dir}")
        candidates = ([int(step)] if explicit else
                      sorted((s for s in self.all_steps()
                              if s <= int(step)), reverse=True))
        last_exc = None
        for s in candidates:
            if self.verify_stamp(s) is False:
                last_exc = ValueError(
                    f"checkpoint step {s} failed its CRC stamp")
            else:
                try:
                    return self._restore_one(s, template)
                except Exception as e:  # noqa: BLE001 — see fallback
                    last_exc = e
            if not explicit:
                from ..utils import slog

                warnings.warn(
                    f"checkpoint step {s} in {self._dir} is corrupt "
                    f"({last_exc}); falling back to the previous "
                    "step", stacklevel=2)
                slog.log_failure("checkpoint.corrupt", stage="restore",
                                 error=last_exc, step=s)
        raise last_exc if explicit else FileNotFoundError(
            f"no intact checkpoint in {self._dir} "
            f"(last error: {last_exc})")

    def restore_or_none(self, step=None, template=None):
        """Like :func:`restore` but returns None when no (intact)
        checkpoint exists."""
        try:
            return self.restore(step=step, template=template)
        except FileNotFoundError:
            return None

    def close(self):
        """Nothing to release (saves are synchronous)."""


_NDARRAY = "__ndarray__"


def _encode(value):
    """``value`` with each numpy array or scalar replaced by a tagged
    tensor, the form :func:`_decode` turns back."""
    import torch

    if isinstance(value, dict):
        return {k: _encode(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_encode(v) for v in value)
    if isinstance(value, (np.ndarray, np.generic)):
        return {_NDARRAY: torch.from_numpy(np.array(value)),
                "scalar": isinstance(value, np.generic)}
    return value


def _decode(value):
    """The inverse of :func:`_encode`."""
    if isinstance(value, dict):
        if _NDARRAY in value:
            arr = value[_NDARRAY].numpy()
            return arr[()] if value["scalar"] else arr
        return {k: _decode(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_decode(v) for v in value)
    return value


def _like(value, template):
    """``value`` cast leaf by leaf to ``template``'s structure and
    dtypes (numpy arrays, tensors, scalars; dicts and sequences
    recurse)."""
    if isinstance(template, dict):
        return {k: _like(value[k], t) for k, t in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_like(v, t) for v, t in zip(value, template))
    if isinstance(template, np.ndarray):
        return np.asarray(value, dtype=template.dtype)
    if hasattr(template, "dtype") and hasattr(template, "device"):
        import torch

        return torch.as_tensor(value, dtype=template.dtype,
                               device=template.device)
    if isinstance(template, (bool, int, float)):
        return type(template)(value)
    return value


def run_survey_with_checkpoints(step_fn, init_state, n_steps, directory,
                                every=50, keep=3):
    """Resumable loop: applies ``state = step_fn(state, i)`` for i in
    [0, n_steps), checkpointing every ``every`` steps and resuming from
    the latest checkpoint when one exists. Returns the final state."""
    from ..utils import slog

    ckpt = SurveyCheckpointer(directory, every=every, keep=keep)
    latest = ckpt.latest_step()
    if latest is None:
        state, start = init_state, 0
    else:
        state = ckpt.restore(latest, template=init_state)
        start = int(latest) + 1
        slog.log_event("survey.resume", step=start)
    try:
        with slog.span("survey.run", start=start, n_steps=int(n_steps)):
            for i in range(start, int(n_steps)):
                state = step_fn(state, i)
                if ckpt.maybe_save(i, state):
                    slog.log_event("survey.checkpoint", step=i)
        if int(n_steps) > 0 and ckpt.latest_step() != int(n_steps) - 1:
            ckpt.save(int(n_steps) - 1, state)
    finally:
        ckpt.close()
    return state


#: seconds a collective waits for its peers before it raises
DIST_TIMEOUT_S = 600.0


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, backend=None,
                           timeout_s=DIST_TIMEOUT_S):
    """Multi-process bring-up: ``torch.distributed.init_process_group``
    with the JAX package's arguments and environment fallbacks
    (COORDINATOR_ADDRESS, NUM_PROCESSES, PROCESS_ID). Call it once per
    process before building the global mesh (:func:`.mesh.make_mesh`
    then spans every rank's devices); a call in a process whose group
    is initialised already does nothing.

    ``coordinator_address`` (``host:port`` of rank 0, or an init URL)
    with ``num_processes`` and ``process_id``; explicit arguments win
    over the environment, and a ``process_id`` of 0 is one. With no
    address, torchrun's ``MASTER_ADDR`` and ``WORLD_SIZE`` (``env://``)
    are used where set; with neither the process stays single-process,
    as JAX's auto-detection does off a pod. A requested bring-up that
    fails raises: it never degrades to N independent single-process
    runs.

    ``backend`` defaults to ``"nccl"`` where CUDA cards are visible and
    ``"gloo"`` for CPU ranks; ranks that share one card take
    ``"gloo"`` (NCCL refuses two ranks on one device), which carries
    CUDA tensors as well. Where a card is visible the process first
    makes its local card current (``LOCAL_RANK``, else ``process_id``
    modulo the card count). Every collective of the group waits at
    most ``timeout_s`` for its peers, then raises, so a rank whose peer
    died ends with an error instead of hanging."""
    import datetime

    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return
    env = os.environ
    addr = coordinator_address or env.get("COORDINATOR_ADDRESS")
    if addr:
        init = addr if "://" in addr else f"tcp://{addr}"
        world = env.get("NUM_PROCESSES", 1)
        rank = env.get("PROCESS_ID", 0)
    elif env.get("MASTER_ADDR") and env.get("WORLD_SIZE"):
        init, world, rank = "env://", env["WORLD_SIZE"], env.get("RANK", 0)
    else:
        return
    # explicit arguments win over the environment; 0 is a valid
    # process_id, so test identity against None, not truthiness
    world = int(num_processes if num_processes is not None else world)
    rank = int(process_id if process_id is not None else rank)
    if torch.cuda.is_available():
        torch.cuda.set_device(int(env.get(
            "LOCAL_RANK", rank % torch.cuda.device_count())))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend, init_method=init, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=float(timeout_s)))


def results_state(n_epochs, n_params=3):
    """Canonical survey state pytree: per-epoch fitted parameters,
    errors, χ², and a validity mask (the write_results CSV columns in
    array form, scint_utils.py:103-202)."""
    return {
        "params": np.zeros((n_epochs, n_params)),
        "errors": np.zeros((n_epochs, n_params)),
        "chisqr": np.zeros(n_epochs),
        "done": np.zeros(n_epochs, dtype=bool),
    }
