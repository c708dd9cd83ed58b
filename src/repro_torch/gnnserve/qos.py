"""Multi-tenant QoS scheduling for the embedding serve engine — the
port's copy of ``repro.gnnserve.qos`` (numpy).

One embedding store serves many workloads at once — user-facing lookups
next to bulk analytics scans.  Without isolation, one batch job starves
interactive traffic, or the whole store runs at the STRICTEST tenant's
staleness bound and every refresh is charged to everyone.  This module
replaces the engine's single global ``staleness_bound`` + FIFO queue
with three cooperating pieces:

``TenantRegistry``
    Tenants declared with a ``priority`` (weight in the row share), a
    ``slot_quota`` (guaranteed — and reclaimable — batch slots), a
    token-bucket ``rate`` (rows/step; 0 = unlimited) and a per-tenant
    ``staleness_slo`` (max pending mutations their reads may observe).

``QoSScheduler`` — weighted-fair slots and rows
    *Slots*: each tenant is guaranteed ``slot_quota`` of the engine's B
    slots.  Idle quota is lent out work-conserving; when the owner shows
    up, a borrowed slot is PREEMPTED (the in-flight query is paused with
    its cursor and pinned snapshot intact and resumes later — pausing
    never tears a response, because the response's epoch is pinned).
    *Rows*: the per-step ``rows_per_step`` budget is split by
    deficit-weighted round-robin (DRR): tenant t accrues a credit of
    ``budget * priority_t / sum(priorities active)`` per step, spends it
    on its slots' rows, and carries the deficit over.  Token buckets cap
    bursty tenants; unused budget is redistributed work-conserving.
    *Starvation bound*: every admitted query with work left makes
    progress within K steps, where K = 1 for unlimited-rate tenants and
    K = ceil(active_slots_t / rate_t) for rate-limited ones — a minimum
    grant overrides any charge- or deficit-depressed credit.

Deadline-driven refresh planning — per-tenant freshness views
    Instead of refreshing whenever global pending >= bound, the planner
    tracks, per tenant, the epoch its reads observe (``view_version``)
    and how many mutation ops that view pre-dates (``unobserved``).  A
    refresh runs only when the TIGHTEST *active* tenant SLO is due —
    mutation batches coalesce up to that deadline — and only the due
    tenants' views advance: a loose-SLO tenant keeps reading its older
    (pinned, never-torn) epoch while a strict tenant triggers a refresh
    next to it.  Refresh compute cost is charged against the LOWEST
    priority (batch) tenants' DRR credit first.

    Because ``delta.resample_rows`` seeds content-addressed (a row's
    draw depends only on its final CSR neighborhood, not on which
    refresh batch it rode in), folding a mutation stream at one tenant's
    deadlines or another's yields bitwise-identical store contents — so
    each tenant's outputs equal a single-tenant engine run at that
    tenant's SLO, bit for bit.

On a memory-budgeted store an old epoch is not reconstructible
(recompute-on-miss replays the CURRENT graphs): if a lagging view hits
evicted rows (``SnapshotMiss``), the engine restarts that query on the
current epoch — fresher than the SLO requires, never staler, and never
torn (counted in ``n_view_restarts``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs

# ----------------------------------------------------------------------
# tenant model
# ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    name: str
    priority: float = 1.0       # weight in the DRR row share
    slot_quota: int = 1         # guaranteed (reclaimable) batch slots
    rate: float = 0.0           # token-bucket rows/step; <= 0 = unlimited
    staleness_slo: int = 64     # max pending mutations a read may observe

    def __post_init__(self):
        assert self.priority > 0, f"{self.name}: priority must be > 0"
        assert self.slot_quota >= 0, f"{self.name}: slot_quota must be >= 0"
        assert self.staleness_slo >= 1, \
            f"{self.name}: staleness_slo must be >= 1"


class TenantRegistry:
    """Declared tenants, by name.  Quotas are validated against the
    engine's slot count when the scheduler binds."""

    def __init__(self, specs: Sequence[TenantSpec]):
        names = [s.name for s in specs]
        assert len(names) == len(set(names)), f"duplicate tenants: {names}"
        assert names, "at least one tenant required"
        self._specs = {s.name: s for s in specs}

    def __iter__(self):
        return iter(self._specs.values())

    def __getitem__(self, name: str) -> TenantSpec:
        return self._specs[name]

    def __contains__(self, name: str) -> bool:
        return name in self._specs

    def __len__(self) -> int:
        return len(self._specs)

    @property
    def names(self) -> List[str]:
        return list(self._specs)

    @property
    def total_quota(self) -> int:
        return sum(s.slot_quota for s in self._specs.values())


def parse_tenants(text: str) -> TenantRegistry:
    """Parse ``"name:priority:slot_quota:rate:slo,..."`` — the CLI
    format of ``--tenants`` (rate 0 = unlimited rows/step), e.g.
    ``"ui:4:2:0:8,batch:1:1:256:512"``."""
    specs = []
    for part in text.split(","):
        fields = part.strip().split(":")
        if len(fields) != 5:
            raise ValueError(
                f"tenant spec {part!r} is not name:priority:quota:rate:slo")
        name, prio, quota, rate, slo = fields
        specs.append(TenantSpec(name=name, priority=float(prio),
                                slot_quota=int(quota), rate=float(rate),
                                staleness_slo=int(slo)))
    return TenantRegistry(specs)


# ----------------------------------------------------------------------
# per-tenant runtime state
# ----------------------------------------------------------------------


@dataclasses.dataclass
class _TenantState:
    spec: TenantSpec
    queue: List = dataclasses.field(default_factory=list)
    credit: float = 0.0          # DRR deficit (negative = owes, e.g.
    #                              after absorbing a refresh charge)
    tokens: float = 0.0
    rr: int = 0                  # intra-tenant slot rotation
    view_version: int = 0        # epoch this tenant's reads observe
    ops_at_view: int = 0         # mutation ops folded into that epoch
    # observability
    n_served: int = 0
    rows_served: int = 0
    waits: List[int] = dataclasses.field(default_factory=list)
    stale_obs: List[int] = dataclasses.field(default_factory=list)
    refresh_rows_charged: float = 0.0
    n_refresh_triggers: int = 0
    slot_steps: int = 0
    n_preemptions: int = 0
    n_view_restarts: int = 0
    n_deferred_pins: int = 0     # pin-steps held behind an in-flight
    #                              chunked refresh (waiter / tail / hold)


# ----------------------------------------------------------------------
# the scheduler
# ----------------------------------------------------------------------


class QoSScheduler:
    """Weighted-fair slot/row scheduling plus deadline-driven refresh
    planning (see the module docstring).  The engine owns the mechanics
    (slots, gathers, the mutation log); this object owns the policy and
    the per-tenant bookkeeping."""

    def __init__(self, registry: TenantRegistry, *, batch_slots: int,
                 rows_per_step: int, burst_steps: float = 4.0,
                 credit_cap_steps: float = 4.0, refresh_charge: float = 1.0,
                 min_grant: int = 1):
        assert registry.total_quota <= batch_slots, \
            (f"sum of slot quotas ({registry.total_quota}) exceeds the "
             f"engine's {batch_slots} batch slots")
        self.registry = registry
        self.B = batch_slots
        self.rows_per_step = rows_per_step
        self.burst_steps = burst_steps
        self.credit_cap_steps = credit_cap_steps
        self.refresh_charge = refresh_charge
        self.min_grant = min_grant
        self.step_no = 0
        self.refresh_rows_uncharged = 0.0
        # tenants whose SLO / fresh=True demanded the refresh currently
        # in flight (chunked jobs only): their views advance at commit,
        # and their unpinned queries defer until then
        self.refresh_waiters: set = set()
        self._st: Dict[str, _TenantState] = {
            s.name: _TenantState(spec=s,
                                 tokens=(s.rate * burst_steps
                                         if s.rate > 0 else 0.0))
            for s in registry}
        # epoch version -> (ops folded, StoreSnapshot); pruned to the
        # versions some tenant's view still references
        self.epochs: Dict[int, Tuple[int, object]] = {}

    # -- ingress --------------------------------------------------------
    def route(self, q) -> None:
        if q.tenant not in self._st:
            raise KeyError(f"unknown tenant {q.tenant!r}; registered: "
                           f"{list(self._st)}")
        q.submit_step = self.step_no
        self._st[q.tenant].queue.append(q)

    def queued(self) -> int:
        return sum(len(t.queue) for t in self._st.values())

    def state(self, name: str) -> _TenantState:
        return self._st[name]

    # -- slots: quota + work-conserving lending + preemptive reclaim ----
    def plan_admission(self, slot_q: Sequence) -> Tuple[List[int], List]:
        """Returns ``(preempt, admit)``: slot indexes whose BORROWED
        query must be paused back to its tenant's queue, and
        ``(slot, query)`` admissions.  Guaranteed quotas are filled
        first (highest priority first), reclaiming borrowed slots when
        no free slot remains; leftover slots are lent round-robin."""
        slots = list(slot_q)
        active = {name: 0 for name in self._st}
        for q in slots:
            if q is not None:
                active[q.tenant] += 1
        free = [i for i, q in enumerate(slots) if q is None]
        order = sorted(self._st.values(),
                       key=lambda t: (-t.spec.priority, t.spec.name))
        preempt, admit = [], []

        def _borrowed_victim():
            # a slot of the lowest-priority tenant holding more slots
            # than its quota; highest slot index for determinism
            cands = []
            for i, q in enumerate(slots):
                if q is None:
                    continue
                t = self._st[q.tenant]
                if active[q.tenant] > t.spec.slot_quota:
                    cands.append((t.spec.priority,
                                  -(active[q.tenant] - t.spec.slot_quota),
                                  -i))
            if not cands:
                return None
            _, _, neg_i = min(cands)
            return -neg_i

        for t in order:
            while t.queue and active[t.spec.name] < t.spec.slot_quota:
                if free:
                    i = free.pop(0)
                else:
                    i = _borrowed_victim()
                    if i is None:
                        break
                    victim = slots[i]
                    preempt.append(i)
                    active[victim.tenant] -= 1
                    self._st[victim.tenant].n_preemptions += 1
                q = t.queue.pop(0)
                slots[i] = q
                active[t.spec.name] += 1
                admit.append((i, q))
        # work-conserving: leftover slots to whoever has work, rotating
        names = sorted(self._st)
        start = self.step_no % max(len(names), 1)
        rotation = names[start:] + names[:start]
        progressed = True
        while free and progressed:
            progressed = False
            for name in rotation:
                if not free:
                    break
                t = self._st[name]
                if t.queue:
                    i = free.pop(0)
                    q = t.queue.pop(0)
                    slots[i] = q
                    active[name] += 1
                    admit.append((i, q))
                    progressed = True
        tel = obs.current()
        if tel.enabled and (preempt or admit):
            # zero-duration structured events: the per-query causal
            # timeline (queue wait -> scheduler grant -> pin -> gather)
            # needs the grant/preempt instants, not just counters
            now = tel.now_ns()
            for i in preempt:
                victim = slot_q[i]
                tel.tracer.record("qos.preempt", now, 0, 0,
                                  {"slot": i, "uid": victim.uid,
                                   "tenant": victim.tenant})
            for i, q in admit:
                tel.tracer.record("qos.grant", now, 0, 0,
                                  {"slot": i, "uid": q.uid,
                                   "tenant": q.tenant})
        return preempt, admit

    def requeue_front(self, q) -> None:
        """A preempted query goes back to the FRONT of its tenant's
        queue, cursor and pinned snapshot intact — it resumes, it does
        not restart."""
        self._st[q.tenant].queue.insert(0, q)

    # -- freshness views ------------------------------------------------
    def unobserved_of(self, name: str, pending: int,
                      ops_drained: int) -> int:
        """Mutation ops a read through this tenant's view pre-dates:
        ops drained into epochs past the view, plus the undrained log."""
        t = self._st[name]
        return (ops_drained - t.ops_at_view) + pending

    def due_tenants(self, slot_q: Sequence, pending: int,
                    ops_drained: int) -> List[str]:
        """Tenants (with demand) whose freshness deadline has passed —
        the tightest active SLO decides whether THIS step refreshes."""
        active = {q.tenant for q in slot_q if q is not None}
        fresh = {q.tenant for q in slot_q
                 if q is not None and q.fresh and q.snap is None}
        due = []
        for name, t in self._st.items():
            if name not in active and not t.queue:
                continue
            if name in fresh or (self.unobserved_of(name, pending,
                                                    ops_drained)
                                 >= t.spec.staleness_slo):
                due.append(name)
        return due

    def record_epoch(self, version: int, ops_folded: int,
                     snapshot) -> None:
        self.epochs[version] = (ops_folded, snapshot)
        self._prune_epochs(version)

    def epoch_snapshot(self, version: int):
        return self.epochs[version][1]

    def advance_views(self, names: Sequence[str], version: int,
                      ops_drained: int, *, refreshed: bool = True) -> None:
        """Move the due tenants' views to ``version``.  ``refreshed``
        is False when no refresh actually ran (the log was empty and the
        view just caught up to an epoch someone else paid for) — only a
        real refresh counts as a trigger."""
        for n in names:
            t = self._st[n]
            if version >= t.view_version:
                t.view_version = version
                t.ops_at_view = ops_drained
                if refreshed:
                    t.n_refresh_triggers += 1
        self._prune_epochs(version)

    def _prune_epochs(self, current: int) -> None:
        live = {t.view_version for t in self._st.values()} | {current}
        self.epochs = {v: e for v, e in self.epochs.items() if v in live}

    def charge_refresh(self, rows_gemm: float) -> None:
        """Charge one refresh's compute against tenants' DRR credit,
        LOWEST priority (batch) first — batch analytics pays for the
        freshness it forces onto the shared store before interactive
        tenants do.  Each tenant absorbs down to a floor of
        ``-credit_cap_steps * rows_per_step`` so the starvation bound
        survives (the minimum grant ignores negative credit)."""
        cost = float(rows_gemm) * self.refresh_charge
        floor = -self.credit_cap_steps * self.rows_per_step
        for t in sorted(self._st.values(),
                        key=lambda t: (t.spec.priority, t.spec.name)):
            if cost <= 0:
                break
            room = max(t.credit - floor, 0.0)
            take = min(cost, room)
            t.credit -= take
            t.refresh_rows_charged += take
            cost -= take
        self.refresh_rows_uncharged += max(cost, 0.0)

    # -- rows: DRR + token buckets + work-conserving redistribution -----
    def allocate(self, active: Sequence[Tuple[int, str, int]],
                 budget: int) -> Dict[int, int]:
        """Split ``budget`` gather rows across the active slots.
        ``active`` is ``[(slot, tenant, rows_still_needed)]``.  The
        returned grants satisfy: sum(grants) <= budget, grants[slot] <=
        need, and every needy slot of a token-solvent tenant gets at
        least ``min_grant`` rows (the starvation bound)."""
        for t in self._st.values():            # token refill, idle incl.
            if t.spec.rate > 0:
                t.tokens = min(t.tokens + t.spec.rate,
                               t.spec.rate * self.burst_steps)
        by_t: Dict[str, List[Tuple[int, int]]] = {}
        for slot, name, need in active:
            if need > 0:
                by_t.setdefault(name, []).append((slot, need))
        if not by_t:
            return {}
        states = [self._st[n] for n in sorted(by_t)]
        wsum = sum(t.spec.priority for t in states)
        want = {t.spec.name: sum(nd for _, nd in by_t[t.spec.name])
                for t in states}

        def _avail(t):
            return t.tokens if t.spec.rate > 0 else float("inf")

        grants: Dict[str, int] = {}
        funded: Dict[str, int] = {}   # the credit-funded share, pre-lending
        total = 0
        for t in states:
            quantum = budget * t.spec.priority / wsum
            t.credit = min(t.credit + quantum,
                           self.credit_cap_steps * quantum)
            g = int(min(want[t.spec.name], max(t.credit, 0.0), _avail(t)))
            # starvation bound: progress every step, token-permitting,
            # regardless of refresh charges or carried deficit
            g = max(g, int(min(want[t.spec.name],
                               len(by_t[t.spec.name]) * self.min_grant,
                               _avail(t))))
            grants[t.spec.name] = g
            funded[t.spec.name] = g
            total += g
        leftover = budget - total
        if leftover < 0:
            # over budget (a credit-rich tenant claimed a burst): trim
            # lowest priority first, but never below a tenant's minimum
            # grant — the starvation bound survives bursts
            for t in sorted(states,
                            key=lambda t: (t.spec.priority, t.spec.name)):
                floor_t = int(min(want[t.spec.name],
                                  len(by_t[t.spec.name]) * self.min_grant,
                                  _avail(t)))
                cut = min(grants[t.spec.name] - floor_t, -leftover)
                if cut > 0:
                    grants[t.spec.name] -= cut
                    leftover += cut
                if leftover >= 0:
                    break
            if leftover < 0:          # budget < sum of min grants
                for t in sorted(states,
                                key=lambda t: (t.spec.priority,
                                               t.spec.name)):
                    cut = min(grants[t.spec.name], -leftover)
                    grants[t.spec.name] -= cut
                    leftover += cut
                    if leftover >= 0:
                        break
        guard = 0
        while leftover > 0 and guard < 64:     # work-conserving rounds
            guard += 1
            cands = [t for t in sorted(
                         states,
                         key=lambda t: (-t.spec.priority, t.spec.name))
                     if grants[t.spec.name] < min(want[t.spec.name],
                                                  _avail(t))]
            if not cands:
                break
            for t in cands:
                room = int(min(want[t.spec.name], _avail(t))) \
                    - grants[t.spec.name]
                extra = min(room, max(leftover // len(cands), 1), leftover)
                grants[t.spec.name] += extra
                leftover -= extra
                if leftover <= 0:
                    break
        out: Dict[int, int] = {}
        for t in states:
            g = grants[t.spec.name]
            # deficit carries over — but only the credit-funded share is
            # charged: rows soaked up work-conserving from capacity NO
            # other tenant wanted are free (use-it-or-lose-it), so idle-
            # time borrowing can never pin a tenant below its weighted
            # share once contention returns
            t.credit -= min(g, funded[t.spec.name])
            if t.spec.rate > 0:
                t.tokens = max(t.tokens - g, 0.0)
            slots = sorted(by_t[t.spec.name])
            k = len(slots)
            base, rem = g // k, g % k
            start = t.rr % k
            t.rr += 1
            for j, (slot, nd) in enumerate(slots):
                extra = 1 if ((j - start) % k) < rem else 0
                out[slot] = min(nd, base + extra)
            spare = g - sum(out[slot] for slot, _ in slots)
            for slot, nd in slots:             # intra-tenant leftovers
                if spare <= 0:
                    break
                add = min(nd - out[slot], spare)
                out[slot] += add
                spare -= add
        return out

    # -- observability --------------------------------------------------
    # wait/staleness sample history per tenant: enough for stable
    # p50/p95, bounded so a long-lived engine can't grow O(queries)
    MAX_SAMPLES = 4096

    def _sample(self, lst: List[int], v: int) -> None:
        lst.append(int(v))
        if len(lst) > self.MAX_SAMPLES:
            del lst[:len(lst) - self.MAX_SAMPLES]

    def on_pin(self, q, staleness: int) -> None:
        t = self._st[q.tenant]
        q.observed_staleness = staleness
        q.first_gather_step = self.step_no
        self._sample(t.stale_obs, staleness)
        self._sample(t.waits, self.step_no - q.submit_step)

    def on_rows(self, name: str, rows: int) -> None:
        self._st[name].rows_served += int(rows)

    def on_view_restart(self, name: str) -> None:
        self._st[name].n_view_restarts += 1

    def on_defer(self, name: str) -> None:
        """One pin-step held behind an in-flight chunked refresh."""
        self._st[name].n_deferred_pins += 1
        obs.add("qos.deferred_pins")

    def on_done(self, q) -> None:
        t = self._st[q.tenant]
        t.n_served += 1
        if q.first_gather_step < 0:            # empty query: never pinned
            self._sample(t.waits, self.step_no - q.submit_step)

    def account_slots(self, slot_q: Sequence) -> None:
        for q in slot_q:
            if q is not None:
                self._st[q.tenant].slot_steps += 1

    def stats(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant p50/p95 queue wait (steps from submit to first
        gather), rows served, observed staleness vs SLO, refresh
        charges, and quota utilization."""
        out: Dict[str, Dict[str, float]] = {}
        steps = max(self.step_no, 1)
        for name, t in self._st.items():
            w = np.asarray(t.waits if t.waits else [0], np.float64)
            so = np.asarray(t.stale_obs if t.stale_obs else [0], np.float64)
            out[name] = {
                "n_served": t.n_served,
                "rows_served": t.rows_served,
                "wait_p50_steps": float(np.percentile(w, 50)),
                "wait_p95_steps": float(np.percentile(w, 95)),
                "staleness_p95": float(np.percentile(so, 95)),
                "staleness_max": float(so.max()),
                "staleness_slo": float(t.spec.staleness_slo),
                "slo_violations": int((so > t.spec.staleness_slo).sum()),
                "refresh_rows_charged": float(t.refresh_rows_charged),
                "n_refresh_triggers": t.n_refresh_triggers,
                "quota_util": (t.slot_steps
                               / (max(t.spec.slot_quota, 1) * steps)),
                "n_preemptions": t.n_preemptions,
                "n_view_restarts": t.n_view_restarts,
                "n_deferred_pins": t.n_deferred_pins,
                "view_version": t.view_version,
            }
        return out


__all__ = ["TenantSpec", "TenantRegistry", "parse_tenants", "QoSScheduler"]
