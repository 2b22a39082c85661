"""End-of-run RunReport: one machine-readable artifact per survey.

The port's own copy of ``scintools_tpu/obs/report.py``, schema for
schema: the RunReport collects a run's outcome into one JSON document
(``run_report.json``) plus a human-rendered markdown table
(``run_report.md``), written into the run's ``workdir`` by
``robust/runner.py:run_survey`` / ``run_survey_batched`` (and
therefore by the survey entries on top of them).

Schema v1 (validated by :func:`validate_run_report`):

=================  =======  ==================================
field              type     meaning
=================  =======  ==================================
schema_version     int      always 1
runner             str      producing entry point
generated_t        float    unix time of assembly
n_epochs           int      epochs scanned (incl. resumed)
n_ok               int      fresh successful epochs
n_quarantined      int      quarantined (incl. resumed-quar.)
n_resumed          int      taken verbatim from the journal
retries            int      total failed ladder attempts
tier_counts        dict     fresh completions per tier
wall_s             float    wall-clock of the run loop
epochs_per_sec     float?   fresh epochs / wall_s (None if 0)
quarantined        list     per-epoch {epoch, error_class,
                            error, tier}
timeline           dict?    StageTimeline.summary() or None
jit_builds         dict     per-site {builds, distinct_keys}
metrics            dict?    MetricsRegistry.snapshot() or None
slo                dict     {global, tenants, sites}: global +
                            per-tenant latency p50/p95 and the
                            cost ledger's per-site steady
                            medians
=================  =======  ==================================

Optional extras (``n_batches`` from the batched runner, caller
``extra`` fields, a streaming run's ``in_progress``/``latency``/
``backlog``) ride along unvalidated. :class:`RunReportBuilder`
produces schema-valid snapshots of a run that is still in flight.
"""

from __future__ import annotations

import json
import os
import time

from ..utils import slog
from . import ledger as _ledger
from . import metrics as _metrics
from . import retrace as _retrace

SCHEMA_VERSION = 1

_REQUIRED = {
    "schema_version": int,
    "runner": str,
    "generated_t": (int, float),
    "n_epochs": int,
    "n_ok": int,
    "n_quarantined": int,
    "n_resumed": int,
    "retries": int,
    "tier_counts": dict,
    "wall_s": (int, float),
    "epochs_per_sec": (int, float, type(None)),
    "quarantined": list,
    "timeline": (dict, type(None)),
    "jit_builds": dict,
    "metrics": (dict, type(None)),
    "slo": dict,
}


def _slo_block(slo=None):
    """Normalise a caller-supplied SLO view into the schema's
    ``slo`` block; the ledger's per-site steady medians fill in when
    the caller didn't supply ``sites`` (batch runners have no
    per-tenant latency, but every runner has a cost ledger)."""
    slo = dict(slo or {})
    sites = slo.get("sites")
    if sites is None:
        sites = _ledger.LEDGER.steady_site_medians()
    return {
        "global": dict(slo.get("global")
                       or {"p50_s": None, "p95_s": None, "n": 0}),
        "tenants": dict(slo.get("tenants") or {}),
        "sites": dict(sites),
    }


def build_run_report(summary, outcomes=(), wall_s=0.0, timeline=None,
                     runner="run_survey", extra=None, slo=None):
    """Assemble the report dict from the runner's tally ``summary``,
    its ordered ``outcomes`` (:class:`EpochOutcome`-like, for the
    quarantine detail), the run's wall seconds, and an optional
    timeline summary dict. Metrics and jit-build accounting are read
    from the process-wide registries; ``slo`` — the serving daemon's
    latency SLO view (:meth:`SurveyService.slo_snapshot`), defaulted
    to a ledger-only block for batch runners."""
    quarantined = []
    for o in outcomes:
        status = getattr(o, "status", None)
        error_cls = getattr(o, "error_class", "")
        if status == "quarantined" or (status == "resumed"
                                       and error_cls):
            quarantined.append({
                "epoch": str(getattr(o, "epoch", "?")),
                "error_class": error_cls,
                "error": getattr(o, "error", ""),
                "tier": getattr(o, "tier", "")})
    fresh = max(0, int(summary.get("n_epochs", 0))
                - int(summary.get("n_resumed", 0)))
    eps = round(fresh / wall_s, 3) if wall_s > 0 and fresh else None
    rep = {
        "schema_version": SCHEMA_VERSION,
        "runner": str(runner),
        "generated_t": round(time.time(), 3),
        "n_epochs": int(summary.get("n_epochs", 0)),
        "n_ok": int(summary.get("n_ok", 0)),
        "n_quarantined": int(summary.get("n_quarantined", 0)),
        "n_resumed": int(summary.get("n_resumed", 0)),
        "retries": int(summary.get("retries", 0)),
        "tier_counts": {str(k): int(v) for k, v in
                        dict(summary.get("tier_counts", {})).items()},
        "wall_s": round(float(wall_s), 4),
        "epochs_per_sec": eps,
        "quarantined": quarantined,
        "timeline": dict(timeline) if timeline else None,
        "jit_builds": _retrace.snapshot(),
        "metrics": (_metrics.REGISTRY.snapshot()
                    if _metrics.REGISTRY.enabled else None),
        "slo": _slo_block(slo),
    }
    if "n_batches" in summary:
        rep["n_batches"] = int(summary["n_batches"])
    if extra:
        rep.update(extra)
    return rep


class RunReportBuilder:
    """Mid-run RunReport snapshots for a long-lived service.

    ``build_run_report`` needs the run's final wall seconds, which a
    still-running service does not have; the builder carries the run's
    start instant instead and stamps each snapshot with the elapsed
    wall time so far, plus an ``in_progress`` marker and any live
    ``extra`` fields (backlog, latency percentiles). Every snapshot
    passes :func:`validate_run_report` — a poller sees the same
    schema the end-of-run artifact has.

    >>> builder = RunReportBuilder(runner="serve_survey")
    >>> rep = builder.snapshot(rec.tally, rec.outcomes,
    ...                        extra={"backlog": 3})
    >>> builder.finalize(workdir, rec.tally, rec.outcomes)
    """

    def __init__(self, runner="serve_survey", extra=None):
        self.runner = str(runner)
        self.extra = dict(extra or {})
        self._t0 = time.perf_counter()

    def wall_s(self):
        return time.perf_counter() - self._t0

    def snapshot(self, summary, outcomes=(), timeline=None,
                 extra=None, in_progress=True, slo=None):
        """A schema-valid report of the run SO FAR (validated before
        it is returned — a malformed snapshot must fail here, not in
        the scraper)."""
        merged = {**self.extra, **(extra or {}),
                  "in_progress": bool(in_progress)}
        return validate_run_report(build_run_report(
            summary, outcomes, wall_s=self.wall_s(),
            timeline=timeline, runner=self.runner, extra=merged,
            slo=slo))

    def finalize(self, workdir, summary, outcomes=(), timeline=None,
                 extra=None, name="run_report", slo=None):
        """Write the closing snapshot (``in_progress: false``) as the
        usual ``run_report.json``/``.md`` pair; returns the JSON
        path."""
        return write_run_report(
            workdir, self.snapshot(summary, outcomes,
                                   timeline=timeline, extra=extra,
                                   in_progress=False, slo=slo),
            name=name)


def validate_run_report(report):
    """Schema-v1 validation:
    required fields present with the right types, tier counts and
    quarantine entries well-formed, JSON-serialisable. Raises
    :class:`ValueError` listing every problem; returns the report."""
    problems = []
    if not isinstance(report, dict):
        raise ValueError("run report must be a dict")
    for key, typ in _REQUIRED.items():
        if key not in report:
            problems.append(f"missing field {key!r}")
        elif not isinstance(report[key], typ):
            problems.append(
                f"field {key!r} has type "
                f"{type(report[key]).__name__}")
    if isinstance(report.get("schema_version"), int) \
            and report["schema_version"] != SCHEMA_VERSION:
        problems.append(
            f"schema_version {report['schema_version']} != "
            f"{SCHEMA_VERSION}")
    for k, v in dict(report.get("tier_counts") or {}).items():
        if not isinstance(v, int):
            problems.append(f"tier_counts[{k!r}] not an int")
    for i, q in enumerate(report.get("quarantined") or []):
        if not isinstance(q, dict) or "epoch" not in q \
                or "error_class" not in q:
            problems.append(f"quarantined[{i}] malformed: {q!r}")
    slo = report.get("slo")
    if isinstance(slo, dict):
        for part, typ in (("global", dict), ("tenants", dict),
                          ("sites", dict)):
            if not isinstance(slo.get(part), typ):
                problems.append(f"slo[{part!r}] missing or not a "
                                f"{typ.__name__}")
        for field in ("p50_s", "p95_s", "n"):
            if isinstance(slo.get("global"), dict) \
                    and field not in slo["global"]:
                problems.append(f"slo['global'] missing {field!r}")
        if isinstance(slo.get("tenants"), dict):
            for t, pct in slo["tenants"].items():
                if not isinstance(pct, dict) or "p95_s" not in pct:
                    problems.append(f"slo['tenants'][{t!r}] malformed")
    try:
        json.dumps(report)
    except (TypeError, ValueError) as e:
        problems.append(f"not JSON-serialisable: {e}")
    if problems:
        raise ValueError("invalid run report: " + "; ".join(problems))
    return report


def render_markdown(report):
    """Human view of the report: a summary table, the per-tier
    completions, and (when any) the quarantine list."""
    r = report
    lines = [
        f"# Survey run report ({r['runner']})", "",
        "| quantity | value |", "|---|---|",
        f"| epochs | {r['n_epochs']} |",
        f"| ok | {r['n_ok']} |",
        f"| quarantined | {r['n_quarantined']} |",
        f"| resumed | {r['n_resumed']} |",
        f"| retries | {r['retries']} |",
        f"| wall_s | {r['wall_s']} |",
        f"| epochs/s | {r['epochs_per_sec']} |",
    ]
    tl = r.get("timeline") or {}
    if tl:
        lines += [f"| overlap_frac | {tl.get('overlap_frac')} |",
                  f"| device_idle_s | {tl.get('device_idle_s')} |"]
    if r.get("tier_counts"):
        lines += ["", "## Completions per tier", "",
                  "| tier | epochs |", "|---|---|"]
        lines += [f"| {t} | {n} |"
                  for t, n in r["tier_counts"].items()]
    if r.get("jit_builds"):
        lines += ["", "## Compiled programs", "",
                  "| site | builds | distinct keys |", "|---|---|---|"]
        lines += [f"| {s} | {d['builds']} | {d['distinct_keys']} |"
                  for s, d in r["jit_builds"].items()]
    slo = r.get("slo") or {}
    g = slo.get("global") or {}
    if g.get("n"):
        lines += ["", "## Latency SLO", "",
                  "| tenant | p50_s | p95_s | n |", "|---|---|---|---|",
                  f"| (all) | {g.get('p50_s')} | {g.get('p95_s')} | "
                  f"{g.get('n')} |"]
        lines += [f"| {t} | {p.get('p50_s')} | {p.get('p95_s')} | "
                  f"{p.get('n')} |"
                  for t, p in (slo.get("tenants") or {}).items()]
    if slo.get("sites"):
        lines += ["", "## Program cost ledger (steady medians)", "",
                  "| site | median_s |", "|---|---|"]
        lines += [f"| {s} | {m} |"
                  for s, m in slo["sites"].items()]
    if r["quarantined"]:
        lines += ["", "## Quarantined epochs", "",
                  "| epoch | error class | error |", "|---|---|---|"]
        lines += [f"| {q['epoch']} | {q['error_class']} | "
                  f"{str(q['error'])[:80]} |"
                  for q in r["quarantined"]]
    return "\n".join(lines) + "\n"


def write_run_report(workdir, report, name="run_report"):
    """Write ``<workdir>/<name>.json`` (+ ``.md``) atomically (write
    to a temp name, ``os.replace``), emit a ``survey.run_report`` slog
    event, and return the JSON path. Never raises into the survey —
    a report that cannot be written is a warning, the journal already
    holds the results."""
    json_path = os.path.join(os.fspath(workdir), name + ".json")
    try:
        for suffix, text in ((".json", json.dumps(report, indent=1)),
                             (".md", render_markdown(report))):
            path = os.path.join(os.fspath(workdir), name + suffix)
            tmp = path + ".tmp"
            with open(tmp, "w") as fh:
                fh.write(text)
            os.replace(tmp, path)
    except OSError as e:
        import sys

        print(f"Warning: run report write failed ({e})",
              file=sys.stderr)
        return None
    slog.log_event("survey.run_report", path=json_path,
                   n_ok=report.get("n_ok"),
                   n_quarantined=report.get("n_quarantined"))
    return json_path
