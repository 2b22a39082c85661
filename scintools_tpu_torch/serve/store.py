"""Append-only, atomically readable results store for the daemon.

The port's own copy of ``scintools_tpu/serve/store.py``. Every published
record is one line of the CRC-JSONL
:class:`~scintools_tpu_torch.parallel.checkpoint.EpochJournal`, so

- a concurrent reader, or a resume after SIGKILL, sees only complete,
  verified records (``EpochJournal.valid_lines`` skips a torn tail);
- a restarted daemon takes journaled epochs verbatim and publishes
  nothing twice;
- two stores are byte-consistent when their valid lines match, and the
  bytes equal the JAX store's for the same records.

On top of the journal the store keeps the content-hash index the
stream dedupe needs: each published record carries the payload's
``sha`` (stamped by the spool watcher), so a duplicate file arriving
under a new name, today or after a restart, is dropped instead of
republished."""

from __future__ import annotations

import hashlib
import os
import threading

from ..parallel.checkpoint import EpochJournal


def content_hash(data):
    """Canonical content hash of an epoch payload (hex sha256).
    Bytes are hashed directly; anything else is hashed via its
    ``repr`` (good enough for the in-process test source — the spool
    watcher always hashes file bytes)."""
    if not isinstance(data, (bytes, bytearray)):
        data = repr(data).encode()
    return hashlib.sha256(data).hexdigest()


class ResultsStore:
    """The daemon's published-results surface over one
    :class:`EpochJournal`.

    ``records()``/``valid_lines()`` are the atomic read API (only
    CRC-intact lines); ``known_content(sha)`` answers the dedupe
    question; ``note_published(key, sha)`` keeps the in-memory hash
    index current as the daemon records fresh epochs (the journal
    line itself carries the ``sha`` field, so the index rebuilds from
    disk on restart).
    """

    def __init__(self, workdir, name="results.jsonl"):
        os.makedirs(os.fspath(workdir), exist_ok=True)
        self.journal = EpochJournal(os.path.join(os.fspath(workdir),
                                                 name))
        self._lock = threading.Lock()
        self._hash_to_key = {}
        for key, rec in self.journal.records().items():
            sha = rec.get("sha")
            if sha:
                self._hash_to_key[sha] = key

    # ---- read side (atomic) -----------------------------------------
    def records(self):
        """``{epoch_id: record}`` of every intact published line."""
        return self.journal.records()

    def valid_lines(self):
        """Intact raw lines in publish order (byte-consistency
        view)."""
        return self.journal.valid_lines()

    def __len__(self):
        return len(self.records())

    # ---- dedupe index -----------------------------------------------
    def known_content(self, sha):
        """Epoch key already published with this content hash, or
        None. ``sha=None`` (no hash available) never matches."""
        if not sha:
            return None
        with self._lock:
            return self._hash_to_key.get(sha)

    def note_published(self, key, sha=None):
        """Record that ``key`` (with payload hash ``sha``) is now
        published, keeping the dedupe index current without a disk
        re-scan."""
        if sha:
            with self._lock:
                self._hash_to_key.setdefault(sha, str(key))
