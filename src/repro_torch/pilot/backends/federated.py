"""Federated multi-backend: health-checked failover and cost-aware placement.

One ``FederatedBackend`` owns N member backends (any mix of the *simulated*
backends — serverless / hpcsim — sharing ONE virtual clock) and presents
the ordinary ``Backend`` surface, so the streaming engine, ``ControlLoop``
and ``FaultInjector`` drive a federation exactly like a single backend.
This is the paper's EILC story taken to backend-level blast radius: one
workload, heterogeneous capacity, one model-driven controller — burst onto
serverless while HPC grants are pending, drain back when cheaper capacity
arrives, and survive a whole-member outage as a degradation instead of a
failure (Lithops' multi-backend invoker/monitor design, Pilot-Streaming's
unified resource abstraction).

Architecture
------------

* **Membership.** ``PilotDescription.attrs["federation"]["members"]`` lists
  member specs (``machine`` or ``resource`` URL, ``price`` per
  unit-second, ``max_units``, optional ``usl`` prior ``(sigma, kappa,
  gamma)``, optional ``grant_latency_s`` prior, per-member backend
  ``attrs``).  Each member gets its own backend *instance* constructed on
  the federation's shared :class:`~repro_torch.sim.des.Simulator` plus an inner
  ``Pilot``, so member state (queues, containers, fault surfaces) stays
  isolated while time is coherent.

* **Routing.** ``scale_to(n)`` splits the total target across members with
  a greedy marginal-score placement: each unit lands on the member
  maximizing ``marginal predicted throughput / (price * (1 +
  grant_latency / glat_scale_s))`` — the price x grant-latency x
  predicted-capacity score, with the per-member prediction coming from a
  per-member :class:`~repro_torch.core.autoscale.OnlineUSLEstimator` (prior from
  the member spec).  Partitions ``0..n-1`` are then assigned to members
  sticky-first (a partition keeps its owner while that owner retains
  quota), and pinned compute units are routed to the owning member with a
  member-local partition rank so each member's own pinning stays dense.

* **Health + circuit breaker (clock-agnostic).** Per-member error-rate and
  grant-latency EWMAs are fed purely from CU completions; breaker
  transitions are evaluated lazily at observation points (submits,
  completions, ``effective_allocation`` reads — i.e. every control tick)
  by *reading* the clock, never by scheduling on it.  States: ``closed``
  (healthy) -> ``open`` on outage signal (error EWMA >=
  ``open_error_rate``, or an injected ``backend_outage``) -> after
  ``open_cooldown_s`` -> ``half_open`` (re-admitted at ``probe_units``
  capacity) -> ``closed`` after ``probe_successes`` clean completions with
  the error EWMA back under ``close_error_rate``; a failure while probing
  re-opens.

* **Drain-and-migrate.** Opening a breaker re-splits the same total target
  across the survivors: the failed member's partitions are re-owned
  sticky-first by survivors, its in-flight CUs die with
  ``ConnectionError`` (the engine's un-pinned retry redelivers them on a
  survivor), and subsequent pinned dispatch routes to the new owners — so
  the at-least-once invariant (``lost == 0``) holds through a full
  member outage.  Partition *count* changes still flow through the
  ordinary ``ControlLoop`` -> ``Broker.repartition`` -> engine migration
  path; failover itself only re-routes ownership.

* **Faults.** ``inject_outage(member, duration_s)`` (the ``backend_outage``
  fault kind) revokes the member's capacity through its own ``preempt``
  surface, fail-fasts submissions while in force and trips the breaker;
  ``inject_grant_starvation`` (the ``grant_starvation`` kind) freezes the
  member's scale-UP and inflates its grant-latency score so bursts land on
  the other members.  ``inject_crash``/``preempt`` fan out round-robin
  across healthy members.  Any fault dirties the member's current
  estimator window: fault-poisoned windows contribute **zero** samples to
  the per-member USL fits (``dirty_windows`` counts them,
  ``dirty_samples`` stays 0 by construction — gated in perf_smoke).

Determinism: no wall clock, no unseeded randomness, no locks; every
decision is a pure function of the shared DES clock and seeded member
backends, so federated runs are bit-identical under a seed.  Mixing sim and
wall (``local://``) members is not supported: the shared clock cannot span
both worlds.

Ports ``repro.pilot.backends.federated``; on the same seed its runs, member
ledgers included, equal the reference's bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Any

from repro_torch.core.autoscale import OnlineUSLEstimator
from repro_torch.core.usl import USLFit
from repro_torch.pilot.api import (Backend, ComputeUnit, Pilot, PilotDescription,
                             State, register_backend)
from repro_torch.sim.des import Simulator

DEFAULTS = dict(
    err_alpha=0.35,          # EWMA weight of the newest completion outcome
    glat_alpha=0.3,          # grant-latency EWMA weight
    open_error_rate=0.5,     # closed -> open at this error EWMA
    close_error_rate=0.2,    # half_open -> closed needs EWMA back under this
    open_cooldown_s=10.0,    # open -> half_open after this long
    probe_units=1,           # capacity cap while half_open
    probe_successes=3,       # clean completions to re-close
    glat_scale_s=10.0,       # grant-latency normalization in the score
    min_window_s=0.5,        # min dt between member capacity samples
    refit_interval_s=10.0,   # per-member estimator refit cadence
)

#: breaker states, in escalation order
BREAKER_STATES = ("closed", "open", "half_open")


def _member_resource(spec: dict) -> str:
    """Resolve a member spec to a backend resource URL (same mapping as
    the platform cells: ``serverless`` -> aws-sim, anything else -> an
    hpcsim machine)."""
    if "resource" in spec:
        return spec["resource"]
    machine = spec.get("machine", "serverless")
    if machine == "serverless":
        return "serverless://aws-sim"
    return f"hpc://{machine}-sim"


@dataclass
class _Member:
    """One federation member: its backend, inner pilot, health state and
    capacity model.  Everything here is driven by CU completions and the
    shared virtual clock — nothing schedules."""

    index: int
    name: str
    backend: Backend
    pilot: Pilot
    price: float = 1.0
    max_units: int = 64
    # breaker / health
    state: str = "closed"
    err_ewma: float = 0.0
    glat_ewma: float = 0.0
    probe_ok: int = 0
    opens: int = 0                 # closed/half_open -> open transitions
    outage_until: float = 0.0
    starved_until: float = 0.0
    open_until: float = 0.0
    # placement / accounting
    target: int = 0                # units the split currently asks it to hold
    outstanding: int = 0           # submitted-but-unfinished CUs
    submitted: int = 0
    completed: int = 0
    failures: int = 0
    cost_integral: float = 0.0     # price-weighted integral of target units
    # estimator feed
    estimator: OnlineUSLEstimator | None = None
    last_sample_t: float = 0.0
    last_completed: int = 0
    dirty: bool = False            # a fault touched this member this window
    dirty_windows: int = 0         # windows skipped because dirty
    dirty_samples: int = 0         # samples admitted while dirty (must stay 0)
    est_samples: int = 0
    # hot-path caches (set once in start_pilot): the submit/finish pair runs
    # per CU, so EWMA constants and the callback live here, not in cfg dicts
    err_keep: float = 0.65         # 1 - err_alpha
    glat_alpha: float = 0.3
    final_cb: Any = None           # pre-bound _on_cu_final(st, m, .)
    cu_list: Any = None            # pilot.compute_units

    def usable(self, now: float) -> bool:
        return self.state != "open" and now >= self.outage_until


class FederatedBackend(Backend):
    """N member backends behind one ``Backend`` surface (see module doc)."""

    scheme = "federated"

    def __init__(self, sim: Simulator | None = None, seed: int = 0,
                 **_kw) -> None:
        self.sim = sim or Simulator(seed=seed)
        self._seed = seed
        self._pilots: dict[int, dict] = {}

    # -- lifecycle -----------------------------------------------------------
    def start_pilot(self, pilot: Pilot) -> None:
        from repro_torch.pilot.api import _BACKENDS   # plugin registry

        spec = dict(pilot.desc.attrs.get("federation") or {})
        member_specs = spec.pop("members", None)
        if not member_specs:
            raise ValueError(
                "federated pilot needs attrs['federation']['members'] "
                "(a list of member specs)")
        cfg = dict(DEFAULTS)
        unknown = set(spec) - set(cfg)
        if unknown:
            raise ValueError(f"unknown federation keys: {sorted(unknown)}")
        cfg.update(spec)

        total = max(1, pilot.desc.partitions)
        members: list[_Member] = []
        for i, mspec in enumerate(member_specs):
            resource = _member_resource(mspec)
            mscheme = resource.split("://", 1)[0]
            if mscheme == self.scheme:
                raise ValueError("federations do not nest")
            backend = _BACKENDS[mscheme](sim=self.sim, seed=self._seed)
            units0 = max(1, total // len(member_specs))
            desc = PilotDescription(
                resource=resource, memory_mb=pilot.desc.memory_mb,
                partitions=units0, concurrency=units0,
                walltime_s=pilot.desc.walltime_s,
                attrs=dict(mspec.get("attrs") or {}))
            inner = Pilot(desc, backend, uid=pilot.uid * 1000 + i)
            backend.start_pilot(inner)
            prior = mspec.get("usl")
            fit = (USLFit(sigma=prior[0], kappa=prior[1], gamma=prior[2],
                          r2=1.0, rmse=0.0, n_obs=0)
                   if prior else
                   # near-linear but concave prior: marginal throughput
                   # shrinks slightly with load, so equal-price members
                   # spread instead of piling onto the lowest index
                   USLFit(sigma=0.0, kappa=1e-3, gamma=1.0,
                          r2=0.0, rmse=0.0, n_obs=0))
            members.append(_Member(
                index=i,
                name=mspec.get("name") or f"{i}:{resource}",
                backend=backend, pilot=inner,
                price=float(mspec.get("price", 1.0)),
                max_units=int(mspec.get("max_units", 64)),
                glat_ewma=float(mspec.get("grant_latency_s", 0.0)),
                estimator=OnlineUSLEstimator(
                    fit, refit_interval_s=cfg["refit_interval_s"]),
            ))
        st = {
            "cfg": cfg,
            "members": members,
            "target": total,
            "granted": total,
            "owner": [],          # partition -> member index
            "rank": [],           # partition -> member-local rank
            "resplit": False,     # a breaker transition wants a re-split
            "fault_rr": 0,        # round-robin cursor for crash/preempt fan-out
            "last_cost_t": self.sim.now,
            "last_probe_t": -1.0,
            # submit fast-path key: the lone member, or None when federated
            "single": members[0] if len(members) == 1 else None,
        }
        self._pilots[pilot.uid] = st
        for m in members:
            m.err_keep = 1.0 - cfg["err_alpha"]
            m.glat_alpha = cfg["glat_alpha"]
            m.final_cb = partial(self._on_cu_final, st, m)
            m.cu_list = m.pilot.compute_units
        self._resplit(st)
        pilot.state = State.RUNNING

    # -- placement -----------------------------------------------------------
    def _caps(self, st: dict, m: _Member, now: float) -> int:
        """Units member *m* may hold right now, breaker- and fault-aware."""
        if m.state == "open" or now < m.outage_until:
            return 0
        if m.state == "half_open":
            return int(st["cfg"]["probe_units"])
        if now < m.starved_until:
            return m.target        # starved: hold, never grow
        return m.max_units

    def _score(self, st: dict, m: _Member, units: int, now: float) -> float:
        """Marginal value of giving member *m* its ``units+1``-th unit:
        predicted marginal throughput over price x normalized grant
        latency — the cost-aware placement score."""
        fit = m.estimator.fit
        marginal = fit.predict(units + 1) - fit.predict(units)
        glat = m.glat_ewma
        if now < m.starved_until:            # pending grants won't arrive
            glat = max(glat, m.starved_until - now)
        denom = m.price * (1.0 + glat / st["cfg"]["glat_scale_s"])
        return marginal / max(denom, 1e-12)

    def _resplit(self, st: dict) -> None:
        """Split ``st['target']`` units across members by greedy marginal
        score, then re-own partitions sticky-first.  Deterministic: ties
        break on member index."""
        now = self.sim.now
        members = st["members"]
        n = st["target"]
        if len(members) == 1:
            # no placement choice: the cap alone decides, no scoring
            units = [min(n, self._caps(st, members[0], now))]
        else:
            units = [0] * len(members)
            # half-open members get their probe quota RESERVED, not competed
            # for: re-admission needs probe traffic even when the member's
            # score loses to every survivor (e.g. it is the expensive one)
            budget = n
            for m in members:
                if m.state == "half_open" and budget > 0:
                    units[m.index] = min(int(st["cfg"]["probe_units"]), budget)
                    budget -= units[m.index]
            for _ in range(budget):
                best, best_score = None, 0.0
                for m in members:
                    if units[m.index] >= self._caps(st, m, now):
                        continue
                    s = self._score(st, m, units[m.index], now)
                    if best is None or s > best_score:
                        best, best_score = m, s
                if best is None:
                    break
                units[best.index] += 1
        if sum(units) == 0:
            # every member is down: park the target on member 0 so the
            # Backend contract (granted >= 1) holds; work fail-fasts and
            # the engine's retry/abandon budget bounds the damage
            units[0] = n
        # sticky re-ownership: a partition keeps its owner while the owner
        # retains quota; freed/new partitions fill from the lowest index.
        # Every partition gets an owner even when caps shrink the split
        # below n (half-open probe, starvation): the surplus partitions
        # cycle over the members that hold units, so pinned dispatch always
        # routes somewhere live
        remaining = list(units)
        owner = [-1] * n
        old = st["owner"]
        for p in range(min(n, len(old))):
            if old[p] >= 0 and remaining[old[p]] > 0:
                owner[p] = old[p]
                remaining[old[p]] -= 1
        fill = [i for i, k in enumerate(remaining) for _ in range(k)]
        holders = [i for i, k in enumerate(units) if k > 0] or [0]
        cyc = 0
        for p in range(n):
            if owner[p] < 0:
                if fill:
                    owner[p] = fill.pop(0)
                else:
                    owner[p] = holders[cyc % len(holders)]
                    cyc += 1
        seen = [0] * len(members)
        rank = [0] * n
        for p in range(n):
            rank[p] = seen[owner[p]]
            seen[owner[p]] += 1
        st["owner"], st["rank"] = owner, rank
        for m in members:
            want = units[m.index]
            if want != m.target or m.target == 0:
                m.target = want
                # member backends clamp to >= 1; a 0-target member keeps one
                # idle unit underneath but it is never routed to nor billed
                m.backend.scale_to(m.pilot, max(1, want))
        st["granted"] = sum(units)
        st["resplit"] = False

    # -- health monitor ------------------------------------------------------
    def _health_feed(self, st: dict, m: _Member, *, failed: bool,
                     grant_s: float | None = None) -> None:
        cfg = st["cfg"]
        a = cfg["err_alpha"]
        m.err_ewma = a * (1.0 if failed else 0.0) + (1.0 - a) * m.err_ewma
        if grant_s is not None:
            g = cfg["glat_alpha"]
            m.glat_ewma = g * grant_s + (1.0 - g) * m.glat_ewma
        now = self.sim.now
        if failed:
            m.dirty = True
            if m.state == "closed" and m.err_ewma >= cfg["open_error_rate"]:
                self._open(st, m, cfg["open_cooldown_s"])
            elif m.state == "half_open":       # failed the probe: back off
                self._open(st, m, cfg["open_cooldown_s"])
        elif m.state == "half_open":
            m.probe_ok += 1
            if (m.probe_ok >= cfg["probe_successes"]
                    and m.err_ewma <= cfg["close_error_rate"]
                    and now >= m.outage_until):
                m.state = "closed"
                st["resplit"] = True           # full re-admission next probe

    def _open(self, st: dict, m: _Member, cooldown_s: float) -> None:
        m.state = "open"
        m.opens += 1
        m.probe_ok = 0
        m.open_until = self.sim.now + cooldown_s
        m.dirty = True
        st["resplit"] = True                   # drain-and-migrate to survivors

    def _probe(self, st: dict) -> None:
        """Lazy observation point: accrue cost, advance breaker timers, and
        sample per-member capacity windows into the estimators.  Runs at
        most once per distinct timestamp (the control loop reads
        ``effective_allocation`` twice per tick)."""
        now = self.sim.now
        if now == st["last_probe_t"]:
            if st["resplit"]:
                self._resplit(st)
            return
        st["last_probe_t"] = now
        dt = now - st["last_cost_t"]
        st["last_cost_t"] = now
        cfg = st["cfg"]
        for m in st["members"]:
            if dt > 0.0:
                m.cost_integral += m.price * m.target * dt
            if m.state == "open" and now >= m.open_until:
                m.state = "half_open"
                m.probe_ok = 0
                st["resplit"] = True           # grant the probe capacity
            wdt = now - m.last_sample_t
            if wdt >= cfg["min_window_s"]:
                done = m.completed
                if m.dirty or not m.usable(now) or now < m.starved_until:
                    # fault-poisoned window: contribute ZERO samples
                    m.dirty_windows += 1
                elif m.target > 0 and m.estimator is not None:
                    rate = (done - m.last_completed) / wdt
                    if m.estimator.observe(now, m.target, rate,
                                           lag=m.outstanding):
                        m.est_samples += 1
                    # the fit is only ever read by _score, and _score only
                    # matters when there is a placement choice: a single-
                    # member federation skips re-fits so the wrapper costs
                    # nothing but the EWMAs
                    if len(st["members"]) > 1:
                        m.estimator.maybe_refit(now)
                m.last_sample_t = now
                m.last_completed = done
                m.dirty = False
        if st["resplit"]:
            self._resplit(st)

    # -- routing -------------------------------------------------------------
    def _route(self, st: dict, cu: ComputeUnit) -> _Member:
        members = st["members"]
        p = cu.desc.partition
        if p is not None and st["owner"]:
            return members[st["owner"][p % len(st["owner"])]]
        # un-pinned (retry / straggler copy): round-robin over usable members
        now = self.sim.now
        usable = [m for m in members if m.usable(now)] or members
        m = usable[st["fault_rr"] % len(usable)]
        st["fault_rr"] += 1
        return m

    def submit(self, pilot: Pilot, cu: ComputeUnit) -> None:
        st = self._pilots[pilot.uid]
        if st["single"] is not None:
            # single-member fast path: routing and rank are the identity
            # (rank[p % n] == p % n, and the member backend pins p % n
            # itself), so skip both.  A fresh CU is never final, so the
            # callback list append needs no is_final gate
            m = st["single"]
            if m.state == "closed" and self.sim.now >= m.outage_until:
                m.submitted += 1
                m.outstanding += 1
                cu.callbacks.append(m.final_cb)
                m.cu_list.append(cu)
                m.backend.submit(m.pilot, cu)
                return
        now = self.sim.now
        m = self._route(st, cu)
        if now < m.outage_until:
            # fail fast, like dispatch to a dead worker: the engine's
            # un-pinned ConnectionError retry re-routes to a survivor
            m.failures += 1
            self._health_feed(st, m, failed=True)
            cu.submit_ts = now
            cu._set_failed(now, ConnectionError(
                f"federated member {m.name} is in outage"))
            return
        if cu.desc.partition is not None and st["rank"]:
            # member-local rank keeps the member's own pinning dense
            cu.desc.partition = st["rank"][cu.desc.partition % len(st["rank"])]
        m.submitted += 1
        m.outstanding += 1
        cu.attrs["member"] = m.index
        cu.add_done_callback(m.final_cb)
        # the member's fault surface scans its own pilot's CU list
        m.cu_list.append(cu)
        m.backend.submit(m.pilot, cu)

    def _on_cu_final(self, st: dict, m: _Member, cu: ComputeUnit,
                     _DONE=State.DONE, _FAILED=State.FAILED) -> None:
        m.outstanding -= 1
        if cu.state is _DONE:
            m.completed += 1
            if m.state == "closed":
                # the per-CU common case, inlined: the same EWMA updates
                # _health_feed would make, minus its breaker branches (all
                # no-ops while closed and healthy)
                m.err_ewma *= m.err_keep
                g = m.glat_alpha
                m.glat_ewma = (g * (cu.start_ts - cu.submit_ts)
                               + (1.0 - g) * m.glat_ewma)
            else:
                self._health_feed(st, m, failed=False, grant_s=cu.wait_time)
        elif cu.state is _FAILED:
            m.failures += 1
            self._health_feed(st, m, failed=True)

    # -- elasticity ----------------------------------------------------------
    def scale_to(self, pilot: Pilot, n: int) -> int:
        st = self._pilots[pilot.uid]
        self._probe(st)
        st["target"] = max(1, int(n))
        self._resplit(st)
        return st["granted"]

    def allocation(self, pilot: Pilot) -> int:
        return self._pilots[pilot.uid]["target"]

    def effective_allocation(self, pilot: Pilot) -> int:
        st = self._pilots[pilot.uid]
        self._probe(st)
        now = self.sim.now
        eff = 0
        for m in st["members"]:
            if m.target <= 0 or not m.usable(now):
                continue
            eff += min(m.backend.effective_allocation(m.pilot), m.target)
        return eff

    # -- fault surface -------------------------------------------------------
    def _fanout(self, st: dict, count: int, hook: str) -> int:
        """Spread ``count`` worker-level faults round-robin across usable
        members via their own fault surfaces."""
        now = self.sim.now
        members = [m for m in st["members"] if m.usable(now)] or st["members"]
        acted = 0
        for i in range(max(0, int(count))):
            m = members[(st["fault_rr"] + i) % len(members)]
            acted += getattr(m.backend, hook)(m.pilot, 1)
            m.dirty = True
        st["fault_rr"] += count
        return acted

    def inject_crash(self, pilot: Pilot, count: int = 1) -> int:
        return self._fanout(self._pilots[pilot.uid], count, "inject_crash")

    def preempt(self, pilot: Pilot, count: int = 1) -> int:
        return self._fanout(self._pilots[pilot.uid], count, "preempt")

    def inject_outage(self, pilot: Pilot, member: int | None = None,
                      duration_s: float = 20.0) -> int:
        """``backend_outage`` fault kind: take one whole member down for
        ``duration_s`` — capacity revoked through its own ``preempt``
        surface, submissions fail fast, breaker opens until the outage
        lifts, partitions migrate to survivors immediately."""
        st = self._pilots[pilot.uid]
        members = st["members"]
        m = members[(member or 0) % len(members)]
        now = self.sim.now
        m.outage_until = max(m.outage_until, now + duration_s)
        revoked = m.backend.preempt(
            m.pilot, m.backend.effective_allocation(m.pilot))
        self._open(st, m, max(duration_s, st["cfg"]["open_cooldown_s"]))
        self._resplit(st)                      # migrate now, not next tick
        return max(1, revoked)

    def inject_grant_starvation(self, pilot: Pilot, member: int | None = None,
                                duration_s: float = 20.0) -> int:
        """``grant_starvation`` fault kind: the member's scale-UP freezes
        and its grant-latency score inflates for ``duration_s``, so bursts
        land on the other members until grants flow again."""
        st = self._pilots[pilot.uid]
        members = st["members"]
        m = members[(member or 0) % len(members)]
        m.starved_until = max(m.starved_until, self.sim.now + duration_s)
        m.dirty = True
        st["resplit"] = True
        return 1

    # -- introspection -------------------------------------------------------
    def member_ledger(self, pilot: Pilot) -> list[dict]:
        """Per-member report card (JSON-able): placement, health, breaker
        history, price-weighted cost and estimator hygiene."""
        st = self._pilots[pilot.uid]
        self._probe(st)
        return [dict(
            name=m.name, price=m.price, units=m.target, state=m.state,
            opens=m.opens, submitted=m.submitted, completed=m.completed,
            failures=m.failures, outstanding=m.outstanding,
            err_ewma=round(m.err_ewma, 6), glat_ewma=round(m.glat_ewma, 6),
            cost_integral=round(m.cost_integral, 6),
            est_samples=m.est_samples, dirty_windows=m.dirty_windows,
            dirty_samples=m.dirty_samples,
            refits=m.estimator.refits if m.estimator else 0,
        ) for m in st["members"]]

    def shared_resource(self, pilot: Pilot, name: str):
        for m in self._pilots[pilot.uid]["members"]:
            try:
                return m.backend.shared_resource(m.pilot, name)
            except LookupError:
                continue
        raise LookupError(f"no federation member exposes {name!r}")

    # -- teardown ------------------------------------------------------------
    def cancel_pilot(self, pilot: Pilot) -> None:
        for m in self._pilots[pilot.uid]["members"]:
            m.backend.cancel_pilot(m.pilot)
        pilot.state = State.CANCELED

    def drive_until(self, predicate, timeout: float | None = None) -> None:
        # all members share self.sim, so one run drives the federation
        self.sim.run_until(
            t=None if timeout is None else self.sim.now + timeout,
            predicate=predicate)
        if not predicate():
            raise TimeoutError("federated drive_until exhausted events/timeout")

    def close(self) -> None:
        for st in self._pilots.values():
            for m in st["members"]:
                m.backend.close()
        self._pilots.clear()


register_backend(FederatedBackend.scheme, FederatedBackend)
