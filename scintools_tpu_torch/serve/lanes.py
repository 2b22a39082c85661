"""Lane assembly for the batched service mode.

The port's own copy of ``scintools_tpu/serve/lanes.py``; for the same
observations it makes the same decisions. The single-epoch dispatch
window pays one device program per arrival; the batched mode makes
epochs LANES of one batched program. This module is the host half: it
decides *when* arrivals become a batch and *which* arrivals share it.

Three pieces, all single-threaded (owned by the daemon's loop thread):

- :class:`AdaptiveBatchController` — maps the live backlog to a
  batch-size target B. **Track-up, decay-down**: on the way up B follows
  the backlog (clipped to ``max_batch``), so a burst is met with a
  full-width batch within one assembly; on the way down B decays
  geometrically (``decay`` per observation), so a one-tick lull does
  not collapse a burst back to B = 1, but a real idle drains to
  single-epoch dispatch in O(log B) ticks;
- :class:`TenantPolicy` — per-tenant admission control (an over-quota
  tenant's arrivals are rejected before they cost a load or a lane) and
  fair-share lane quotas (a cap on the fraction of one batch a tenant
  may fill);
- :class:`LaneAssembler` — the staging buffer: loaded epochs wait keyed
  by geometry and tenant, and ``take(B)`` forms one group per geometry,
  tenants round-robin (FIFO within a tenant).

Groups are padded up to power-of-two buckets (:func:`bucket_size`,
:func:`pad_group`) with copies of a real payload, whose results are
discarded: steady-state service then builds O(log max_batch) programs
once and no more."""

from __future__ import annotations

from collections import OrderedDict, deque


def amortisation_factor(t1, tb, b):
    """How much batching amortises, from measured service times:
    ``t1`` — median seconds of a 1-lane batch, ``tb`` — median
    seconds of a ``b``-lane batch (the program cost ledger's
    ``serve.batch`` site supplies both).

    Returns a factor in [0, 1]: 1 when the batch costs the same as a
    single dispatch (fixed dispatch cost dominates — lanes are free,
    batch as wide as possible), 0 when the batch costs ``b`` single
    dispatches (compute-bound — lanes are marginal cost, and padding
    up to power-of-two buckets burns real seconds). Derived from the
    marginal-lane-cost ratio ``rho = (tb / b) / t1`` normalised so
    perfect amortisation (``rho = 1/b``) maps to 1 and none
    (``rho = 1``) to 0. None when the inputs can't support the
    estimate (missing samples, b <= 1)."""
    try:
        t1, tb, b = float(t1), float(tb), int(b)
    except (TypeError, ValueError):
        return None
    if t1 <= 0.0 or tb <= 0.0 or b <= 1:
        return None
    rho = (tb / b) / t1
    factor = (1.0 - rho) / (1.0 - 1.0 / b)
    return min(1.0, max(0.0, factor))


def bucket_size(n, cap):
    """Smallest power-of-two >= ``n``, clipped to ``cap`` (``cap``
    itself is always a valid bucket, power of two or not)."""
    n = max(1, int(n))
    cap = max(1, int(cap))
    if n >= cap:
        return cap
    b = 1
    while b < n:
        b <<= 1
    return min(b, cap)


def pad_group(payloads, cap):
    """Pad a group's payload list up to its bucket size with copies
    of the first payload. Returns ``(padded, n_real)`` — callers
    slice the program's results back to ``n_real`` lanes."""
    payloads = list(payloads)
    n = len(payloads)
    b = bucket_size(n, cap)
    return payloads + [payloads[0]] * (b - n), n


class AdaptiveBatchController:
    """Backlog-adaptive batch-size target (the ``serve_backlog_depth``
    feedback loop).

    ``observe(backlog)`` returns the new target B:

    - growth: ``B = min(max_batch, ceil(gain * backlog))`` whenever
      that exceeds the current target — B tracks the backlog up;
    - decay: otherwise ``B = max(that, floor(decay * B))`` — geometric
      drain toward 1 at idle (``decay`` in [0, 1), default 0.5).

    Deterministic and side-effect free apart from the retained
    target, so the step response is unit-testable without a daemon.
    """

    def __init__(self, max_batch=16, gain=1.0, decay=0.5,
                 min_gain=0.25, min_decay=0.25):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1: {max_batch}")
        if not 0.0 <= decay < 1.0:
            raise ValueError(f"decay must be in [0, 1): {decay}")
        self.max_batch = int(max_batch)
        self.gain = float(gain)
        self.decay = float(decay)
        # the configured law is the ceiling the scheduler works under
        self._base_gain = float(gain)
        self._base_decay = float(decay)
        self.min_gain = float(min_gain)
        self.min_decay = float(min_decay)
        self._b = 1

    @property
    def current(self):
        return self._b

    def reschedule(self, t1, tb, b):
        """Gain-schedule the law from measured batch service time
        (the program cost ledger's ``serve.batch`` site): interpolate
        ``gain``/``decay`` between the configured values (fully-amortised batching —
        the constant-lane-cost assumption holds) and
        ``min_gain``/``min_decay`` (compute-bound — each lane costs
        real seconds, so B should under-track the backlog to cut
        power-of-two padding waste and drain faster at lulls).

        ``t1``/``tb``/``b`` as in :func:`amortisation_factor`;
        typically the ledger's ``serve.batch`` steady medians for
        bucket 1 and the widest observed bucket ``b``. Returns the
        factor applied, or None (law untouched) when the measurement
        can't support one."""
        factor = amortisation_factor(t1, tb, b)
        if factor is None:
            return None
        lo_g = min(self.min_gain, self._base_gain)
        lo_d = min(self.min_decay, self._base_decay)
        self.gain = lo_g + (self._base_gain - lo_g) * factor
        self.decay = lo_d + (self._base_decay - lo_d) * factor
        return factor

    def observe(self, backlog):
        target = int(-(-self.gain * max(0, backlog) // 1))  # ceil
        target = min(self.max_batch, target)
        if target >= self._b:
            self._b = max(1, target)
        else:
            self._b = max(1, target, int(self.decay * self._b))
        return self._b


class TenantPolicy:
    """Admission control + fair-share lane quotas per tenant.

    ``max_pending`` — admission cap: a tenant with that many epochs
    already admitted-but-unpublished has further arrivals rejected
    (status ``"rejected"``; the epoch is never loaded). ``None``
    disables admission control.

    ``quotas`` — per-tenant fraction of any single batch the tenant
    may fill (default ``default_quota``, 1.0 = no cap). The effective
    per-batch lane cap is ``max(1, floor(quota * B))``: even a
    heavily-capped tenant always gets at least one lane per batch it
    has pending work for, and the round-robin assembler gives every
    pending tenant its turn before anyone gets seconds — so a
    flooding tenant cannot crowd a quiet one out of lanes either way.
    """

    def __init__(self, max_pending=None, quotas=None,
                 default_quota=1.0):
        self.max_pending = None if max_pending is None \
            else int(max_pending)
        self.quotas = dict(quotas or {})
        self.default_quota = float(default_quota)

    def admit(self, tenant, pending):
        """True when ``tenant`` (with ``pending`` epochs in flight)
        may admit one more."""
        return self.max_pending is None or pending < self.max_pending

    def lane_cap(self, tenant, b):
        """Max lanes of a ``b``-wide batch this tenant may fill."""
        q = float(self.quotas.get(tenant, self.default_quota))
        return max(1, min(int(b), int(q * int(b))))


class LaneAssembler:
    """Staging buffer turning admitted arrivals into device groups.

    Entries are staged under ``(geometry, tenant)``; ``take(b)``
    picks the geometry with the most staged work (one batched program
    per geometry — mixed shapes never share a batch) and fills up to
    ``b`` lanes from it, visiting that geometry's tenants round-robin
    starting after the last tenant served, FIFO within each tenant,
    honoring ``policy.lane_cap``. Returns ``(geometry, entries)`` or
    ``None`` when empty.
    """

    def __init__(self, policy=None):
        self.policy = policy
        # geometry -> OrderedDict(tenant -> deque of entries);
        # insertion order of the tenant map IS the round-robin order
        self._staged = OrderedDict()
        self._count = 0
        self._rr_last = None

    def __len__(self):
        return self._count

    def stage(self, entry, tenant, geometry):
        tenants = self._staged.setdefault(geometry, OrderedDict())
        tenants.setdefault(tenant, deque()).append(entry)
        self._count += 1

    def staged_tenants(self, geometry=None):
        """Tenants with staged work (for one geometry, or overall)."""
        geoms = [geometry] if geometry is not None \
            else list(self._staged)
        out = set()
        for g in geoms:
            for t, q in self._staged.get(g, {}).items():
                if q:
                    out.add(t)
        return out

    def take(self, b):
        b = max(1, int(b))
        geometry, found, best = None, False, 0
        for g, tenants in self._staged.items():
            n = sum(len(q) for q in tenants.values())
            if n > best:
                geometry, found, best = g, True, n
        if not found:
            return None
        tenants = self._staged[geometry]
        order = [t for t, q in tenants.items() if q]
        # resume the wheel after the last tenant served so repeated
        # small batches don't always favor the first-staged tenant
        if self._rr_last in order:
            i = order.index(self._rr_last) + 1
            order = order[i:] + order[:i]
        caps = {t: (self.policy.lane_cap(t, b) if self.policy
                    else b) for t in order}
        picked = []
        taken = {t: 0 for t in order}
        while len(picked) < b:
            progressed = False
            for t in order:
                if len(picked) >= b:
                    break
                q = tenants[t]
                if not q or taken[t] >= caps[t]:
                    continue
                picked.append(q.popleft())
                taken[t] += 1
                self._rr_last = t
                progressed = True
            if not progressed:
                break
        self._count -= len(picked)
        for t in [t for t, q in tenants.items() if not q]:
            del tenants[t]
        if not tenants:
            del self._staged[geometry]
        return geometry, picked
