"""A run whose timed path is broken underneath comes out not correct:
the harness is driven on the CPU at a tiny size, past its look for a
card, once sound and once for each fault the cells can have: an answer
altered where it is produced, and half of the batch left out with the
mean taken over the rest. (The cells train nothing and span one card,
so no step returns its state unchanged and no exchange between cards
can be left out.)"""

import io
import json
import time

import pytest

from portbench import harness


def _run(cell, cfg, tr, bench):
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(cell, 2 ** 33 + 17, 0.5, 0, time.perf_counter(),
                     device="cpu", out=out, err=err, bench=bench,
                     overrides=dict(config=cfg, traffic=tr))
    assert rc == 0, err.getvalue()
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _alter_one_chunk(monkeypatch):
    from scintools_tpu_torch.thth import search

    for name in ("multi_chunk_search", "multi_chunk_search_thin"):
        real = getattr(search, name)

        def altered(*a, _real=real, **kw):
            res = _real(*a, **kw)
            res[0].eta *= 1.02
            return res

        monkeypatch.setattr(search, name, altered)


def _half_the_rows(monkeypatch):
    from scintools_tpu_torch import dynspec

    real = dynspec.global_eta_fit

    def half(eta_evo, eta_evo_err, f0s, fref, time_avg=False):
        h = len(f0s) // 2
        return real(eta_evo[:h], eta_evo_err[:h], f0s[:h], fref, time_avg)

    monkeypatch.setattr(dynspec, "global_eta_fit", half)


FAULTS = [None, _alter_one_chunk, _half_the_rows]


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in ("thth_4096.standard", "thth_4096.thin")
    for f in range(len(FAULTS))])
def test_broken_timed_path_is_not_correct(cell, fault, shrink, monkeypatch):
    cfg, tr, bench = shrink(cell)
    breaker = FAULTS[fault]
    if breaker is not None:
        breaker(monkeypatch)
    res = _run(cell, cfg, tr, bench)
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert res["correct"] is (breaker is None), res["checks"]
    assert list(res)[-1] == "checks" and res["checks"]
