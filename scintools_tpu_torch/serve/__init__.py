"""Survey as a service: the streaming ingest daemon and its live
telemetry — the port's own copy of ``scintools_tpu/serve``.

- :mod:`~scintools_tpu_torch.serve.watch` — epoch sources: the
  torn-file-safe polling :class:`SpoolWatcher` over a spool directory
  and the in-process :class:`QueueSource`;
- :mod:`~scintools_tpu_torch.serve.daemon` — :class:`SurveyService`, the
  streaming ingest loop (PrefetchLoader → dispatch-ahead window or lane
  groups → fence → publish), content-hash dedupe, per-epoch latency;
- :mod:`~scintools_tpu_torch.serve.store` — :class:`ResultsStore`, the
  append-only, atomically readable results store on the CRC-JSONL
  journal;
- :mod:`~scintools_tpu_torch.serve.http` — :class:`TelemetryServer`:
  ``/metrics``, ``/healthz``, ``/readyz``, ``/report``, ``/state``,
  ``/ledger``;
- :mod:`~scintools_tpu_torch.serve.lanes` — the batched mode's host
  half: :class:`AdaptiveBatchController`, :class:`TenantPolicy`,
  :class:`LaneAssembler`.

``dynspec.serve_psrflux_survey`` and ``dynspec.serve_fits_survey`` are
the file-format entry points.
"""

from .daemon import SurveyService
from .http import TelemetryServer
from .lanes import AdaptiveBatchController, LaneAssembler, TenantPolicy
from .store import ResultsStore, content_hash
from .watch import ArrivedEpoch, QueueSource, SpoolWatcher

__all__ = ["AdaptiveBatchController", "ArrivedEpoch", "LaneAssembler",
           "QueueSource", "ResultsStore", "SpoolWatcher", "SurveyService",
           "TelemetryServer", "TenantPolicy", "content_hash"]
