"""Observability of the port: the metrics registry, build accounting,
the program cost ledger, Chrome-trace export, heartbeats, the RunReport
and the pod-level telemetry plane — the port's own copies of
``scintools_tpu/obs``, schema for schema — and the port's own program
spans on the profiler's clock (:func:`span`, :func:`program_spans`).
``obs.programs`` is not ported: its probes trace jaxprs for the JAX
package's own lint pass."""

from . import heartbeat, ledger, metrics, plane, report, retrace, trace
from .heartbeat import (Heartbeat, HeartbeatScanner, as_heartbeat,
                        scan_heartbeat_dir)
from .ledger import LEDGER, ProgramLedger
from .metrics import (REGISTRY, Counter, Gauge, Histogram, MetricsRegistry,
                      aggregate_snapshots, counter, gauge, histogram,
                      set_enabled)
from .plane import SnapshotMerger, TelemetryPlane, snapshot_to_prometheus
from .report import (RunReportBuilder, build_run_report, render_markdown,
                     validate_run_report, write_run_report)
from .retrace import (RetraceRegression, compile_counts, record_build,
                      retrace_guard)
from .trace import (chrome_trace_events, load_trace_fragments,
                    merge_traces, program_spans, span,
                    validate_chrome_trace, write_chrome_trace,
                    write_merged_trace)

__all__ = [
    "heartbeat", "ledger", "metrics", "plane", "report", "retrace", "trace",
    "Heartbeat", "HeartbeatScanner", "as_heartbeat", "scan_heartbeat_dir",
    "LEDGER", "ProgramLedger", "REGISTRY", "Counter", "Gauge",
    "Histogram", "MetricsRegistry", "aggregate_snapshots", "counter",
    "gauge", "histogram", "set_enabled", "RunReportBuilder",
    "build_run_report", "render_markdown", "validate_run_report",
    "write_run_report", "RetraceRegression", "compile_counts",
    "record_build", "retrace_guard", "chrome_trace_events",
    "load_trace_fragments", "merge_traces", "program_spans", "span",
    "validate_chrome_trace",
    "write_chrome_trace", "write_merged_trace", "SnapshotMerger",
    "TelemetryPlane", "snapshot_to_prometheus",
]
