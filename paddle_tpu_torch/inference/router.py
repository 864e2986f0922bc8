"""Front-door router: admission across N serving-engine replicas with
cache/adapter affinity, plus the workload-policy surface.  A copy of
``paddle_tpu/inference/router.py`` (it imports no jax) over the port's
``ServingEngine``: on the same trace it makes the same routing, failover
and handoff decisions and emits the same flight-recorder events.

Everything below the router is a single ``ServingEngine``:
trace-in/stats-out, one queue, one block pool.  Real traffic needs the
layer the reference stack calls the server side — something that owns
admission across replicas, keeps a request's state while it waits,
and speaks workload shapes (chat streaming, offline batch, embeddings)
without forking the engine.  This module is that layer, kept
deliberately in-process and deterministic (threads would buy nothing
on a single host and would cost the byte-identical scheduling contract
every parity test in this repo leans on):

- **Replicas**: ``Router([eng0, eng1, ...])`` owns N homogeneous
  ``ServingEngine`` instances (same model geometry — checked at
  construction).  ``step()`` routes every ARRIVED router-queued
  request, then steps each engine once; ``run()`` drains everything,
  like the engine's own loop.  Future arrivals are ROUTER-held: they
  are routed with the freshest affinity/load state at arrival time,
  and router-level cancel/shed/timeout can still reach them.
- **Affinity routing** (``affinity=True``): the routing key is
  ``(load, -adapter_hit, -prefix_tokens, -blocks_free, index)`` over
  ``ServingEngine.load_report()`` snapshots — load (outstanding
  requests: queued + active + swapped) is PRIMARY, and affinity is a
  strict tie-break inside an equal-load class, never an override: a
  hot prefix must not pile requests onto an overloaded replica (the
  same strictness argument as the engine's cache-aware admission).
  Inside
  the tie-break, adapter residency ranks before prefix tokens — a
  missed adapter costs a whole-adapter swap-in, a missed prefix at
  most one prompt recompute — then the token-granular
  ``RadixPrefixCache`` match (``ServingEngine.prefix_match()``,
  read-only), so a conversation lands where its history is hottest
  and prefix-cache hit tokens multiply across replicas instead of
  diluting.
  ``affinity=False`` is pure round-robin — the A/B arm — and a
  single-replica router schedules byte-identically to the bare
  engine either way (the acceptance anchor).
- **Workload policies**: ``submit(policy=)`` selects per-request
  defaults instead of an engine fork — ``"chat"`` (streaming on,
  interactive priority), ``"batch"`` (offline, priority 0),
  ``"embed"`` (prefill-only: ``max_new_tokens`` forced to 1, the
  prompt's forward pass is the product).  Explicit kwargs win over
  policy defaults.
- **Overload semantics lifted from the engine**: the router's own
  bounded
  queue (``max_queue=``) sheds a strictly-lower-class router-held
  victim or refuses the arrival with ``AdmissionError``; router-held
  requests past ``max_queue_delay_s`` finish ``"timeout"``; and
  ``cancel()`` reaches a request still sitting in the router queue
  (counted ``serving.requests_cancelled{phase="router"}``) as well as
  one already inside an engine (delegated).
- **Replica failover** (``failover=True``, the default): the router
  owns a per-replica HEALTH model.  A replica whose ``step()`` raises
  a replica-fatal signal — ``ReplicaKilledError`` (crash),
  ``PoisonedDispatchError`` (a harvest failed validation: the
  int-token analogue of non-finite logits) or ``EngineStalledError``
  (a dispatch that will never return) — leaves the routing set, is
  restarted (``ServingEngine.crash_reset``) and its requests are
  RECOVERED: still-queued ones re-route immediately; swapped ones
  whose host-RAM parcel survived migrate at EXACT at-rest bytes
  (``HostTier.transfer`` into the destination tier +
  ``ServingEngine.migrate_in`` — the engine's swap gather/scatter
  programs, now crossing replicas); in-flight ones (KV died with the
  device) recompute from the prompt, bit-identically, because the
  victim's position-keyed PRNG base key travels with them — a
  ``TokenStream`` splices at the last flushed token without
  double-emitting.  Each failover costs one unit of a bounded
  ``retry_budget``; exhaustion is the typed terminal state
  ``"failed"``.  Recovered replicas are PROBED (a 1-token request
  driven to completion) before rejoining on probation, and promoted
  to healthy after a fault-free probation window.
- **Observability**: ``serving.router.*`` instruments (requests by
  policy, routing decisions by reason, affinity token/hit counters,
  queue depth, replica faults / failover paths / probes / migrated
  blocks+bytes) and ``route`` / ``fail`` / ``migrate`` / ``retry``
  flight-recorder events (chosen engine, affinity score, policy,
  fault kind, migrated block count) so ``explain_request`` can say
  "routed to engine 1 (prefix affinity 384 tokens)" or "failed over
  to engine 0 (migrated 6 blocks at exact bytes)".

The streamed half of the front door lives in ``serving.py``
(``TokenStream``): ``submit(stream=True)`` — engine- or router-level —
returns a handle whose flushes are the dispatch-ahead harvest points.
"""

from __future__ import annotations

import time
from typing import List, Optional, Union

import numpy as np

from ..observability import fleet as obs_fleet
from ..observability import metrics as obs_metrics
from ..observability.flightrec import FlightRecorder
from .prefixcache import HostTier
from .sampling import SamplingParams
from .serving import (TERMINAL_STATES, AdmissionError,
                      EngineStalledError, PoisonedDispatchError,
                      ReplicaKilledError, Request, ServingEngine,
                      TokenStream, _neg_deadline)

# per-request defaults each workload policy applies (explicit submit
# kwargs always win).  "embed" is the prefill-only shape: the request's
# product is its prompt forward pass, so the decode budget is pinned to
# the 1-token minimum the engine's first-token sampling needs — an
# explicit larger budget is a contradiction and raises.
ROUTER_POLICIES = {
    "chat": {"stream": True, "priority": 1},
    "batch": {"stream": False, "priority": 0},
    "embed": {"stream": False, "priority": 1, "max_new_tokens": 1},
}

# closed vocabulary of routing-decision reasons
# (serving.router.routed{reason=}): what distinguished the chosen
# replica — round_robin (affinity disabled), adapter (its AdapterStore
# holds the request's adapter in HBM), prefix (its radix tree matched
# >= 1 prompt token), load (plain least-outstanding / index order)
ROUTE_REASONS = ("round_robin", "adapter", "prefix", "load")

# closed vocabularies of the failover layer (every literal site
# resolves against these):
# how a replica failed — the typed signal its step() raised
# (serving.router.failover.replica_faults{fault=})
REPLICA_FAULTS = ("kill", "poison", "stall")
# how an affected request was recovered
# (serving.router.failover.requests{path=}): "migrate" = its swap
# parcel's exact at-rest bytes moved to a healthy replica's host tier
# and resumed there, "recompute" = re-ran from the prompt (the
# position-keyed PRNG makes the replayed stream bit-identical),
# "requeue" = it was still queued on the victim, so a plain fresh
# placement suffices
FAILOVER_PATHS = ("migrate", "recompute", "requeue")
# health-probe outcomes (serving.router.failover.probes{outcome=})
PROBE_OUTCOMES = ("pass", "fail")
# per-replica health lifecycle: "unhealthy" replicas are out of the
# routing set; a passed probe moves them to "probation" (routable, but
# one more fault sends them straight back), and a fault-free
# probation window promotes them to "healthy"
HEALTH_STATES = ("healthy", "probation", "unhealthy")

# the replica-fatal exception types the failover layer consumes — any
# OTHER exception from an engine step is a programming error and
# propagates (failing over a code bug would retry it forever)
REPLICA_FAULT_ERRORS = (ReplicaKilledError, PoisonedDispatchError,
                        EngineStalledError)


def _classify_fault(err: BaseException) -> str:
    """The ``REPLICA_FAULTS`` entry for a caught replica-fatal
    exception."""
    if isinstance(err, ReplicaKilledError):
        return "kill"
    if isinstance(err, PoisonedDispatchError):
        return "poison"
    return "stall"


class _RouterInstruments:
    """Registry handles + per-router baselines (the engine's
    ``_ServingInstruments`` discipline: instruments may live in a
    shared registry, ``stats()`` reports per-router deltas)."""

    def __init__(self, registry):
        self.registry = registry
        r = registry
        self.requests = r.counter(
            "serving.router.requests",
            "requests accepted by the router front door, by workload "
            "policy ('default' when submitted without one)",
            labels=("policy",))
        self.routed = r.counter(
            "serving.router.routed",
            "routing decisions (request -> engine replica) by what "
            "distinguished the chosen replica: 'round_robin' "
            "(affinity disabled), 'adapter' (request's adapter is "
            "HBM-resident there), 'prefix' (its radix tree matched "
            "prompt tokens), 'load' (plain least-outstanding order)",
            labels=("reason",))
        self.prefix_tokens = r.counter(
            "serving.router.prefix_affinity_tokens",
            "prompt tokens the CHOSEN replica's prefix tree had "
            "already matched at each routing decision — the affinity "
            "signal's magnitude (the admission-time re-probe decides "
            "what actually maps; see serving.prefix.hit_tokens)")
        self.adapter_hits = r.counter(
            "serving.router.adapter_affinity_hits",
            "routing decisions whose chosen replica already held the "
            "request's LoRA adapter in HBM (each one is an adapter "
            "swap-in the fleet did not pay)")
        self.shed = r.counter(
            "serving.router.shed",
            "requests shed by the router's bounded queue: 'evicted' = "
            "a router-held request displaced by a strictly-higher-"
            "class arrival, 'rejected' = an arrival refused with "
            "AdmissionError", labels=("reason",))
        self.timeouts = r.counter(
            "serving.router.timeouts",
            "router-held requests finished with status 'timeout' "
            "because their wait exceeded max_queue_delay_s before any "
            "replica admitted them (engine-side queue timeouts count "
            "in serving.timeout.requests)")
        self.queue_depth = r.gauge(
            "serving.router.queue_depth",
            "requests the router holds (not yet dispatched to any "
            "replica: future arrivals, or arrivals every replica "
            "refused)")
        self.engines = r.gauge(
            "serving.router.engines",
            "engine replicas behind this router")
        self.healthy_engines = r.gauge(
            "serving.router.healthy_engines",
            "replicas currently in the routing set (health 'healthy' "
            "or 'probation'); engines minus this is the failed count")
        self.replica_faults = r.counter(
            "serving.router.failover.replica_faults",
            "replica-fatal faults the router observed, by kind: "
            "'kill' (the replica's step raised ReplicaKilledError), "
            "'poison' (a harvest failed validation — "
            "PoisonedDispatchError), 'stall' (EngineStalledError: a "
            "dispatch that will never return)", labels=("fault",))
        self.failover_requests = r.counter(
            "serving.router.failover.requests",
            "requests recovered off a failed replica, by path: "
            "'migrate' = exact-bytes KV migration through the host "
            "tier, 'recompute' = deterministic re-run from the "
            "prompt, 'requeue' = was still queued, placed fresh",
            labels=("path",))
        self.failover_failed = r.counter(
            "serving.router.failover.failed",
            "requests that reached the terminal state 'failed': their "
            "replica died and the bounded retry budget ran out")
        self.probes = r.counter(
            "serving.router.failover.probes",
            "health probes against unhealthy replicas, by outcome "
            "('pass' readmits the replica on probation; 'fail' keeps "
            "it out of the routing set)", labels=("outcome",))
        self.readmissions = r.counter(
            "serving.router.failover.readmissions",
            "recovered replicas readmitted to the routing set after "
            "a passed probe (the probation entry point)")
        self.migrate_blocks = r.counter(
            "serving.migrate.blocks",
            "KV blocks moved between replicas at exact at-rest bytes "
            "during failover (victim host-tier parcel -> destination "
            "host tier -> destination arenas via the swap-in scatter)")
        self.migrate_bytes = r.counter(
            "serving.migrate.bytes",
            "at-rest KV bytes (codes + scale planes for the int8 "
            "cache) moved between replicas during failover migration")
        self.fleet_snapshots = r.counter(
            "serving.fleet.snapshots",
            "Router.fleet_snapshot() calls — each merges every "
            "replica's registry snapshot, health state and "
            "load_report() into one replica-labeled fleet view (the "
            "tools/serving_top.py surface)")
        # router-phase cancels share the ENGINE counter (same name,
        # kind and label tuple, so shared registries re-use the
        # instrument): phase='router' is the queue level above any
        # engine
        self.cancelled = r.counter(
            "serving.requests_cancelled",
            "requests dropped by cancel(); the label says which phase "
            "the request was cancelled from (queued / prefill / "
            "decode / swapped)", labels=("phase",))
        self._base = {c.name: c.total() for c in (
            self.requests, self.routed, self.prefix_tokens,
            self.adapter_hits, self.shed, self.timeouts,
            self.replica_faults, self.failover_requests,
            self.failover_failed, self.probes, self.readmissions,
            self.migrate_blocks, self.migrate_bytes)}
        self._cancel_base = self.cancelled.value(phase="router")
        self._routed_base = {reason: self.routed.value(reason=reason)
                             for reason in ROUTE_REASONS}

    def since_init(self, counter) -> float:
        return counter.total() - self._base.get(counter.name, 0)

    def routed_since(self, reason: str) -> float:
        return (self.routed.value(reason=reason)
                - self._routed_base.get(reason, 0))


class RoutedRequest:
    """The router's request handle: a queue-side record before
    dispatch, a transparent proxy of the engine ``Request`` after.

    Before any replica admits it, the handle carries the router-level
    lifecycle itself (``state`` queued/cancelled/shed/timeout, empty-
    then-padded ``tokens``); once routed, every request-shaped read
    (``state``/``tokens``/``output``/``ttft``/``latency``/
    ``request_id``) delegates to the live engine request, so callers
    hold ONE handle for the whole lifecycle.  ``router_id`` is the
    router-global id (engine ``request_id``s are per-replica and may
    collide across replicas); ``engine`` is the chosen replica index
    (None while router-held)."""

    def __init__(self, router_id: int, ids: np.ndarray, seq_len: int,
                 max_new_tokens: int, arrival_time: float,
                 pad_token_id: int, policy: Optional[str]):
        self.router_id = int(router_id)
        self.engine: Optional[int] = None
        self._req: Optional[Request] = None
        self._state = "queued"
        self._tokens: List[int] = []
        self._ids = ids
        self.seq_len = int(seq_len)
        self.max_new_tokens = int(max_new_tokens)
        self.arrival_time = float(arrival_time)
        self.pad_token_id = int(pad_token_id)
        self.policy = policy
        self.finish_time_router: Optional[float] = None
        # scheduling class (shed ordering only; the engine re-derives
        # its own from the dispatched kwargs)
        self.priority = 0
        self.deadline: Optional[float] = None
        self.max_queue_delay_s: Optional[float] = None
        self.adapter: Optional[str] = None
        self._kw: dict = {}
        # failover bookkeeping: how many times this request was
        # recovered off a failed replica (bounded by the router's
        # retry_budget), and the token prefix it had emitted at the
        # last failover — the deterministic-replay contract the
        # router verifies at the retried finish
        self.retries = 0
        self._replay: List[int] = []

    def _bind(self, engine_idx: int, req: Request):
        self.engine = int(engine_idx)
        self._req = req

    def _unbind(self, tokens_so_far: List[int]):
        """Detach from a failed replica's request: the handle keeps
        the already-emitted tokens as its own truth while the router
        recovers it onto a healthy replica."""
        self._req = None
        self.engine = None
        self._state = "queued"
        self._tokens = list(tokens_so_far)

    def _terminate(self, state: str, now: float):
        """Router-level terminal: same uniform shape as the engine's
        (terminal state, output padded to exactly max_new_tokens)."""
        self._state = state
        self.finish_time_router = now
        self._tokens.extend(
            [self.pad_token_id] * (self.max_new_tokens
                                   - len(self._tokens)))

    @property
    def routed(self) -> bool:
        return self._req is not None

    @property
    def state(self) -> str:
        return self._req.state if self._req is not None else self._state

    @property
    def tokens(self) -> List[int]:
        if self._req is not None:
            live = self._req.tokens
            if self._replay and len(self._replay) > len(live):
                # a failover RECOMPUTE is replaying its deterministic
                # prefix (the new engine request restarts from the
                # prompt); present the longer truth so the handle's
                # view is monotonic — the replayed tokens are
                # bit-identical to the saved ones (verified at the
                # retried finish), so no reader can see a divergence
                return list(self._replay)
            return live
        return self._tokens

    @property
    def output(self) -> np.ndarray:
        return np.asarray(self.tokens, np.int32)

    @property
    def request_id(self) -> Optional[int]:
        """The ENGINE-side request id (None while router-held)."""
        return (self._req.request_id if self._req is not None
                else None)

    @property
    def finish_time(self) -> Optional[float]:
        if self._req is not None:
            return self._req.finish_time
        return self.finish_time_router

    @property
    def latency(self) -> Optional[float]:
        ft = self.finish_time
        return None if ft is None else ft - self.arrival_time

    @property
    def ttft(self) -> Optional[float]:
        return self._req.ttft if self._req is not None else None

    def __getattr__(self, name):
        req = self.__dict__.get("_req")
        if req is not None:
            return getattr(req, name)
        raise AttributeError(
            f"RoutedRequest has no attribute {name!r} (the request "
            f"has not been routed to an engine yet)")


class Router:
    """Admission owner over N in-process ``ServingEngine`` replicas —
    see the module docstring for the routing/policy/overload design.

    ``engines`` must be geometry-homogeneous (same prompt_len /
    block_len / max_cache_len / pad token / KV dtype): the router
    validates capacity once against replica 0 and any replica must be
    able to serve any request.  Pass a private ``registry=`` when two
    routers are A/B-compared (the engine-stats sharing caveat) and a
    ``flight_recorder=`` for ``route``-event timelines keyed by
    ``router_id`` (each ENGINE keeps its own recorder; engine request
    ids are per-replica)."""

    def __init__(self, engines: List[ServingEngine], *,
                 affinity: bool = True, max_queue: Optional[int] = None,
                 failover: bool = True, retry_budget: int = 3,
                 probe_interval: int = 1, probation_steps: int = 2,
                 registry=None, flight_recorder=None,
                 monitor=None, timeseries=None,
                 clock=time.perf_counter):
        if not engines:
            raise ValueError("Router needs >= 1 engine replica")
        if int(retry_budget) < 0:
            raise ValueError(
                f"retry_budget must be >= 0 failovers per request, "
                f"got {retry_budget}")
        if int(probe_interval) < 1:
            raise ValueError(
                f"probe_interval must be >= 1 router steps, got "
                f"{probe_interval}")
        if int(probation_steps) < 0:
            raise ValueError(
                f"probation_steps must be >= 0, got {probation_steps}")
        self._engines = list(engines)
        e0 = self._engines[0]
        for i, e in enumerate(self._engines[1:], start=1):
            for attr in ("prompt_len", "max_cache_len", "block_len",
                         "num_blocks", "kv_cache_dtype"):
                if getattr(e, attr) != getattr(e0, attr):
                    raise ValueError(
                        f"replica {i} differs from replica 0 on "
                        f"{attr} ({getattr(e, attr)} vs "
                        f"{getattr(e0, attr)}) — the router assumes "
                        f"any replica can serve any request")
            if e.cfg.pad_token_id != e0.cfg.pad_token_id:
                raise ValueError(
                    f"replica {i} pad_token_id {e.cfg.pad_token_id} "
                    f"!= replica 0's {e0.cfg.pad_token_id}")
        # disaggregation roles: the ONE homogeneity
        # exemption — roles are routing policy, not geometry.  Fresh
        # arrivals need a prefill-capable replica; a fleet with any
        # "prefill" replica needs a decode-capable one to hand off to,
        # or every chunk-final parcel would wait forever.
        self._roles = [str(getattr(e, "role", "both"))
                       for e in self._engines]
        if not any(r in ("prefill", "both") for r in self._roles):
            raise ValueError(
                f"no prefill-capable replica (roles={self._roles}) — "
                f"fresh arrivals could never be placed")
        if any(r == "prefill" for r in self._roles) and \
                not any(r in ("decode", "both") for r in self._roles):
            raise ValueError(
                f"prefill-role replicas but no decode-capable one "
                f"(roles={self._roles}) — chunk-final handoffs could "
                f"never be placed")
        self.affinity = bool(affinity)
        self.max_queue = None if max_queue is None else int(max_queue)
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(
                f"max_queue must be >= 1 (or None = unbounded), got "
                f"{max_queue}")
        self._clock = clock
        self._queue: List[RoutedRequest] = []   # router-held only
        self._handles: List[RoutedRequest] = []  # submission order
        # requests swept terminal OUTSIDE a step (the submit-path
        # timeout sweep): buffered so the NEXT step() returns them —
        # run()'s "this call's terminal handles" contract must not
        # silently lose a handle
        self._orphan_terminals: List[RoutedRequest] = []
        self._by_engine: dict = {}  # (engine idx, engine rid) -> handle
        self._rr = 0                # round-robin cursor
        self._next_id = 0
        self._step_idx = 0
        # failover health model: per-replica health state, the next
        # step each unhealthy replica may be probed at, the step each
        # probation ends at, and the recovery records awaiting a
        # healthy placement (each is one affected request's snapshot
        # off a failed replica)
        self.failover = bool(failover)
        self.retry_budget = int(retry_budget)
        self.probe_interval = int(probe_interval)
        self.probation_steps = int(probation_steps)
        self._health = ["healthy"] * len(self._engines)
        self._next_probe = [0] * len(self._engines)
        self._probation_until = [0] * len(self._engines)
        self._recover: List[dict] = []
        # chunk-final handoff records awaiting a decode-capable
        # placement (the disaggregation twin of _recover: same parcel
        # staging, same migrate_in placement, no retry-budget charge —
        # a handoff is scheduled work, not a fault)
        self._handoffs: List[dict] = []
        # the router-owned staging tier migration parcels ride
        # through: HostTier.transfer moves the victim's exact
        # at-rest bytes here BEFORE its crash_reset drops the source
        # tier, and transfers them on to the chosen destination at
        # placement (preempt-reason parcels always fit)
        self._stage = HostTier(cache_capacity_blocks=0)
        self._m = _RouterInstruments(
            registry if registry is not None
            else obs_metrics.get_registry())
        self._m.engines.set(len(self._engines))
        self._m.healthy_engines.set(len(self._engines))
        self._m.queue_depth.set(0)
        self._fr = (flight_recorder if flight_recorder is not None
                    else FlightRecorder(enabled=False))
        self._fr.bind_clock(clock)
        # fleet observability plane (observability.fleet /
        # .timeseries): the monitor adopts the router's registry and
        # recorder unless constructed with its own, and both are
        # driven once at the end of every step() — step-indexed, so
        # replaying a trace reproduces samples and alerts exactly
        self._monitor = monitor
        if monitor is not None:
            monitor._bind(self._m.registry, self._fr)
        self._ts = timeseries

    # -- intake --
    def submit(self, prompt_ids, seq_len=None, max_new_tokens=None,
               arrival_time=None, policy: Optional[str] = None,
               stream: Optional[bool] = None,
               spec_decode=None,
               sampling: Optional[SamplingParams] = None,
               priority: Optional[int] = None,
               deadline_s: Optional[float] = None,
               max_queue_delay_s: Optional[float] = None,
               adapter: Optional[str] = None,
               tenant: Optional[str] = None
               ) -> Union[RoutedRequest, TokenStream]:
        """Accept one request at the front door.  ``policy`` selects
        workload defaults (``ROUTER_POLICIES``: "chat" streams at
        interactive priority, "batch" is offline priority 0, "embed"
        is prefill-only with ``max_new_tokens`` pinned to 1); every
        other kwarg has ``ServingEngine.submit`` semantics and an
        explicit value always wins over the policy default.  Returns
        the :class:`RoutedRequest` handle — or, with streaming on, a
        :class:`TokenStream` over it whose flushes land at the chosen
        engine's harvest points.  The request is routed to a replica
        at the next ``step()`` after its arrival time; until then it
        is router-held (cancel/shed/timeout reach it here)."""
        defaults = {}
        if policy is not None:
            if policy not in ROUTER_POLICIES:
                raise ValueError(
                    f"unknown router policy {policy!r} — known: "
                    f"{sorted(ROUTER_POLICIES)}")
            defaults = ROUTER_POLICIES[policy]
        if policy == "embed" and max_new_tokens is not None \
                and int(max_new_tokens) != 1:
            raise ValueError(
                f"policy='embed' is prefill-only (max_new_tokens "
                f"pinned to 1) but max_new_tokens={max_new_tokens} "
                f"was passed — drop the kwarg or the policy")
        m = int(max_new_tokens if max_new_tokens is not None
                else defaults.get("max_new_tokens", 32))
        do_stream = bool(stream if stream is not None
                         else defaults.get("stream", False))
        prio = int(priority if priority is not None
                   else defaults.get("priority", 0))
        # fail-fast validation against replica-0 geometry (replicas
        # are homogeneous) so a doomed request errors HERE, not inside
        # a later step().  This deliberately mirrors (not shares)
        # ServingEngine.submit's checks: the engine's validation is
        # interleaved with its probe/rollback state machine and cannot
        # be called statelessly.  The engine re-validates at dispatch,
        # so a drift between the copies cannot admit an invalid
        # request — and _route_arrived drops the request terminal
        # before re-raising, so it cannot wedge the queue either; keep
        # the two blocks in sync when adding submit kwargs.
        e0 = self._engines[0]
        ids = np.asarray(prompt_ids).reshape(-1).astype(np.int32)
        if ids.size < 1 or ids.size > e0.prompt_len:
            raise ValueError(
                f"prompt must be 1..{e0.prompt_len} tokens, got "
                f"{ids.size}")
        n = int(seq_len) if seq_len is not None else int(ids.size)
        if n < 1 or n > ids.size:
            raise ValueError(
                f"seq_len must be in [1, {ids.size}], got {n}")
        if m < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {m}")
        if n + m - 1 > e0.max_cache_len:
            raise ValueError(
                f"prompt ({n}) + max_new_tokens ({m}) - 1 = "
                f"{n + m - 1} tokens exceeds max_cache_len "
                f"({e0.max_cache_len})")
        if e0._blocks_needed(n, m) > e0.num_blocks:
            raise ValueError(
                f"request needs {e0._blocks_needed(n, m)} blocks but "
                f"each replica pool has num_blocks={e0.num_blocks} — "
                f"no replica could ever admit it")
        if adapter is not None:
            adapter = str(adapter)
            for i, e in enumerate(self._engines):
                if e._adapters is None or \
                        e._adapters.state(adapter) is None:
                    raise ValueError(
                        f"adapter {adapter!r} is not registered on "
                        f"replica {i} — every replica must be able "
                        f"to serve any request")
        if sampling is not None:
            if not isinstance(sampling, SamplingParams):
                raise ValueError(
                    f"sampling must be a SamplingParams, got "
                    f"{type(sampling).__name__}")
            sampling.validate()
        if spec_decode is not None:
            # mirror the engine's spec validation (a value the engine
            # would reject must fail HERE — a dispatch-time ValueError
            # would escape step()/run() instead of submit())
            if int(spec_decode) < 1:
                raise ValueError(
                    f"spec_decode must be >= 1 draft tokens, got "
                    f"{spec_decode}")
            if sampling is not None and \
                    sampling.mask_processor is not None:
                raise ValueError(
                    "spec_decode cannot compose with a token-mask "
                    "processor (see ServingEngine.submit)")
        if deadline_s is not None and float(deadline_s) <= 0:
            raise ValueError(
                f"deadline_s must be > 0 seconds from arrival, got "
                f"{deadline_s}")
        if max_queue_delay_s is not None \
                and float(max_queue_delay_s) < 0:
            raise ValueError(
                f"max_queue_delay_s must be >= 0, got "
                f"{max_queue_delay_s}")
        now = self._clock()
        arrival = now if arrival_time is None else float(arrival_time)
        pr = RoutedRequest(self._next_id, ids, n, m, arrival,
                           e0.cfg.pad_token_id, policy)
        pr.priority = prio
        pr.deadline = (None if deadline_s is None
                       else arrival + float(deadline_s))
        pr.max_queue_delay_s = (None if max_queue_delay_s is None
                                else float(max_queue_delay_s))
        pr.adapter = adapter
        pr._kw = dict(seq_len=n, max_new_tokens=m,
                      arrival_time=arrival, spec_decode=spec_decode,
                      sampling=sampling, priority=prio,
                      deadline_s=(None if deadline_s is None
                                  else float(deadline_s)),
                      max_queue_delay_s=pr.max_queue_delay_s,
                      adapter=adapter, tenant=tenant)
        # bounded front-door queue, the engine's semantics over ROUTER-HELD
        # requests only (dispatched ones are the engines' problem):
        # sweep expired waiters first, then mark a strictly-worse
        # victim for displacement or refuse THIS arrival.  The victim
        # is shed only AFTER the arrival is safely enqueued — the
        # engine's rollback-symmetry discipline: a typed failure
        # after the enqueue (a raising recorder/span hook) must leave
        # queue depth, gauges and the victim exactly as before, so
        # everything from the append on rolls back in one except
        # block and a failed submit never destroys an innocent
        # queued request
        evict = None
        if self.max_queue is not None and \
                len(self._queue) >= self.max_queue:
            self._sweep_timeouts(now, self._orphan_terminals)
        if self.max_queue is not None and \
                len(self._queue) >= self.max_queue:
            worst = min(reversed(self._queue), key=self._shed_key)
            if self._shed_key(worst) < (prio,
                                        _neg_deadline(pr.deadline)):
                evict = worst
            else:
                self._m.shed.inc(reason="rejected")
                raise AdmissionError(
                    f"router queue full ({len(self._queue)} >= "
                    f"max_queue={self.max_queue}) and no router-held "
                    f"request is of strictly lower class than this "
                    f"arrival (priority={prio}, "
                    f"deadline_s={deadline_s})",
                    queue_depth=len(self._queue),
                    max_queue=self.max_queue)
        self._next_id += 1
        try:
            self._queue.append(pr)
            self._handles.append(pr)
            self._fr.emit("submit", pr.router_id, self._step_idx,
                          seq_len=n, max_new=m, priority=prio,
                          policy=(policy if policy is not None
                                  else "default"),
                          queue_depth=len(self._queue))
            if evict is not None:
                self._queue.remove(evict)
                evict._terminate("shed", now)
                self._m.shed.inc(reason="evicted")
                self._fr.emit("shed", evict.router_id, self._step_idx)
            # counters LAST, once nothing can raise (a Counter cannot
            # be decremented — the engine submit's discipline)
            self._m.requests.inc(
                policy=policy if policy is not None else "default")
            self._m.queue_depth.set(len(self._queue))
        except BaseException:
            if self._queue and self._queue[-1] is pr:
                self._queue.pop()
            if self._handles and self._handles[-1] is pr:
                self._handles.pop()
            self._m.queue_depth.set(len(self._queue))
            raise
        if do_stream:
            return TokenStream(self, pr)
        return pr

    @staticmethod
    def _shed_key(pr: RoutedRequest):
        """"Worseness" (smaller = shed first): lowest priority, then
        latest deadline — the engine's ordering lifted as-is."""
        return (pr.priority, _neg_deadline(pr.deadline))

    # -- lifecycle --
    def cancel(self, handle_or_id) -> bool:
        """Drop a request wherever it currently lives.  Router-held:
        removed from the front-door queue, terminal ``"cancelled"``,
        counted ``serving.requests_cancelled{phase="router"}`` — the
        queue level no single engine can see.  Already routed:
        delegated to the owning engine's ``cancel()`` (which counts
        its own phase).  Accepts a handle or a ``router_id``.
        Returns False for unknown/already-terminal requests."""
        if isinstance(handle_or_id, RoutedRequest):
            pr = handle_or_id
        else:
            rid = int(handle_or_id)
            pr = next((h for h in self._handles
                       if h.router_id == rid), None)
            if pr is None:
                return False
        if pr._req is not None:
            return self._engines[pr.engine].cancel(pr._req.request_id)
        if pr._state != "queued":
            return False
        rec = next((r for r in self._recover if r["handle"] is pr),
                   None)
        lane = self._recover
        if rec is None:
            rec = next((r for r in self._handoffs
                        if r["handle"] is pr), None)
            lane = self._handoffs
        if rec is not None:
            # cancelled while its failover recovery or chunk-final
            # handoff awaited placement (unbound: not in the router
            # queue, not on any engine) — drop the record and its
            # staged parcel
            lane.remove(rec)
            if rec["parcel"] is not None:
                self._stage.drop(rec["parcel"]["skey"])
            pr._terminate("cancelled", self._clock())
            self._m.cancelled.inc(phase="router")
            self._fr.emit("cancel", pr.router_id, self._step_idx,
                          phase="router")
            return True
        self._queue.remove(pr)
        pr._terminate("cancelled", self._clock())
        self._m.cancelled.inc(phase="router")
        self._m.queue_depth.set(len(self._queue))
        self._fr.emit("cancel", pr.router_id, self._step_idx,
                      phase="router")
        return True

    def _sweep_timeouts(self, now: float, out: List[RoutedRequest]):
        """Finish router-held requests whose wait broke their
        queue-delay SLO — the engine's rule applied one level up (a
        request that never even reached a replica queue is the
        clearest possible timeout)."""
        for pr in [p for p in self._queue
                   if p.max_queue_delay_s is not None
                   and now - p.arrival_time > p.max_queue_delay_s]:
            self._queue.remove(pr)
            pr._terminate("timeout", now)
            self._m.timeouts.inc()
            self._fr.emit("timeout", pr.router_id, self._step_idx)
            out.append(pr)
        self._m.queue_depth.set(len(self._queue))

    # -- routing --
    def _phase_ok(self, ei: int, phase: str) -> bool:
        """Can replica ``ei`` serve ``phase`` work?  ``"prefill"`` =
        fresh prompts (roles "prefill"/"both"), ``"decode"`` =
        resumed decode parcels (roles "decode"/"both").  An all-
        ``"both"`` fleet passes every phase — the role layer is then
        inert and routing is byte-identical to the pre-role router."""
        role = self._roles[ei]
        return role == "both" or role == phase

    def _choose(self, pr: RoutedRequest, phase: str = "prefill"):
        """Pick a replica order for ``pr`` (best first) plus each
        candidate's affinity metadata ``meta[engine] = (prefix_tokens,
        adapter_hit)`` — the decision instruments/event must describe
        the replica that actually ACCEPTED, which under a bounded-
        engine-queue spill may not be the best-ranked one.  Affinity
        mode sorts by ``(load, -adapter_hit, -prefix_tokens,
        -blocks_free, index)`` — load primary, affinity a strict
        tie-break (see module docstring); round-robin mode cycles the
        cursor (every candidate's metadata is zero: affinity was
        never consulted).  ``phase`` is the disaggregation routing
        key: fresh arrivals (including ``embed`` — prefill IS its
        product) consider only prefill-capable replicas, handoff and
        decode-parcel placements only decode-capable ones."""
        routable = [i for i, s in enumerate(self._health)
                    if s != "unhealthy" and self._phase_ok(i, phase)]
        if not routable:
            return [], {}
        n = len(routable)
        if not self.affinity:
            first = self._rr % n
            self._rr += 1
            order = [routable[(first + k) % n] for k in range(n)]
            return order, {i: (0, False) for i in order}
        scored = []
        meta = {}
        for i in routable:
            e = self._engines[i]
            rep = e.load_report()
            load = (rep["queue_depth"] + rep["active_slots"]
                    + rep["swapped_waiting"])
            ahit = int(pr.adapter is not None
                       and pr.adapter in rep["hbm_adapters"])
            ptok = e.prefix_match(pr._ids[:pr.seq_len])
            scored.append((load, -ahit, -ptok, -rep["blocks_free"], i))
            meta[i] = (ptok, bool(ahit))
        scored.sort()
        return [s[4] for s in scored], meta

    def _route_arrived(self, now: float):
        """Dispatch every ARRIVED router-held request, in submission
        (FIFO) order — class ordering is the ENGINE's job once queued,
        and FIFO dispatch keeps the single-replica router's engine-
        side schedule byte-identical to bare submission.  A replica
        refusing with ``AdmissionError`` (bounded engine queue) spills
        to the next candidate; when every replica refuses, the
        request stays router-held and retries next step.  Any OTHER
        engine-submit failure is a programming error the router's own
        fail-fast validation should have caught — the request is
        dropped terminal first so a raise cannot wedge the queue into
        re-raising forever."""
        for pr in [p for p in self._queue if p.arrival_time <= now]:
            order, meta = self._choose(pr)
            req = None
            for ei in order:
                try:
                    req = self._engines[ei].submit(
                        pr._ids, **pr._kw)
                except AdmissionError:
                    continue
                except BaseException:
                    self._queue.remove(pr)
                    pr._terminate("cancelled", now)
                    self._m.queue_depth.set(len(self._queue))
                    raise
                break
            if req is None:
                continue                    # every replica refused
            self._queue.remove(pr)
            pr._bind(ei, req)
            self._by_engine[(ei, req.request_id)] = pr
            # decision metadata of the replica that actually took the
            # request (a spill target's own affinity, not the best
            # candidate's)
            ptok, ahit = meta[ei]
            reason = ("round_robin" if not self.affinity else
                      "adapter" if ahit else
                      "prefix" if ptok > 0 else "load")
            self._m.routed.inc(reason=reason)
            if ptok:
                self._m.prefix_tokens.inc(ptok)
            if ahit:
                self._m.adapter_hits.inc()
            # rid = the engine-side id the replica assigned: the
            # binding the fleet stitcher uses to re-key that replica's
            # events onto this router-global id (no global clock)
            # shard-group identity rides the route event: a
            # mesh replica's label (e.g. "tp2@d0"), "single" for a
            # single-chip engine — the fleet stitcher narrates which
            # shard group served the request without a second probe
            sg = getattr(self._engines[ei], "shard_group", None)
            # transport identity rides the route event only
            # when the replica IS remote — local engines keep their
            # local event shape byte-identical (the loopback-identity
            # contract compares attrs minus this key)
            tk = getattr(self._engines[ei], "transport_kind", None)
            extra = {} if tk is None else {"transport": tk}
            self._fr.emit(
                "route", pr.router_id, self._step_idx, engine=ei,
                affinity=int(ptok), adapter_hit=int(ahit),
                policy=(pr.policy if pr.policy is not None
                        else "default"),
                reason=reason, rid=req.request_id,
                shard=(sg["label"] if sg is not None else "single"),
                **extra)
        self._m.queue_depth.set(len(self._queue))

    # -- failover: health model, recovery, probation --
    def _set_health(self, ei: int, state: str):
        self._health[ei] = state
        self._m.healthy_engines.set(
            sum(s != "unhealthy" for s in self._health))

    def _fail_over(self, ei: int, err: BaseException, now: float,
                   out: List[RoutedRequest]):
        """One replica just raised a replica-fatal error from its
        ``step()``.  Mark it unhealthy, snapshot every affected
        request off its (still-readable) host-side state, restart it
        (``crash_reset``) and queue the recoveries:

        - requests still QUEUED on the victim re-route immediately
          (path ``requeue`` — nothing ran, a fresh placement is
          exact);
        - SWAPPED requests whose host-RAM parcel is reachable migrate
          at exact at-rest bytes (path ``migrate`` — the parcel
          survived the device fault by construction: preempt parcels
          are materialized host numpy at swap-out);
        - in-flight requests (their KV lived in the dead device)
          recompute from the prompt (path ``recompute`` — the
          position-keyed PRNG replays the emitted prefix
          bit-identically, and the handle splices without
          double-emitting).

        Each failover consumes one unit of the request's retry
        budget; exhaustion is the typed terminal state ``"failed"``.
        With ``failover=False`` (the kill-switch arm) every
        affected request goes terminal ``"failed"`` instead and the
        replica stays out of the routing set."""
        fault = _classify_fault(err)
        self._m.replica_faults.inc(fault=fault)
        self._set_health(ei, "unhealthy")
        self._next_probe[ei] = self._step_idx + self.probe_interval
        eng = self._engines[ei]
        bound = sorted(
            (h for (e_i, _rid), h in self._by_engine.items()
             if e_i == ei),
            key=lambda h: h.router_id)
        affected = [h for h in bound
                    if h.state not in TERMINAL_STATES]
        recs = []
        for h in affected:
            req = h._req
            rec = {
                "handle": h,
                "samp_base": (None if req.samp_base is None
                              else np.array(req.samp_base)),
                "tokens": [int(x) for x in req.tokens],
                "first_token_time": req.first_token_time,
                "was_queued": req.state == "queued",
                "parcel": None,
            }
            if req.state == "swapped" and req.swap is not None:
                # move the parcel out BEFORE the reset drops the tier
                # — host RAM survives a device fault, which is the
                # whole migration story.  HostTier.transfer carries
                # the exact at-rest bytes into the router's staging
                # tier (resolving a still-lazy parcel: its bytes must
                # exist somewhere before the source forgets them)
                skey = eng._host_tier.transfer(req.swap.host_key,
                                               self._stage)
                if skey is not None:
                    rec["parcel"] = {
                        "skey": skey,
                        "n_blocks": req.swap.n_blocks,
                        "tok": req.swap.tok, "lens": req.swap.lens,
                        "phase": req.swap.state, "pf_pos": req.pf_pos,
                    }
            recs.append(rec)
        eng.crash_reset()
        for k in [k for k in self._by_engine if k[0] == ei]:
            del self._by_engine[k]
        tk = getattr(eng, "transport_kind", None)
        textra = {} if tk is None else {"transport": tk}
        for rec in recs:
            h = rec["handle"]
            path = ("migrate" if rec["parcel"] is not None else
                    "requeue" if rec["was_queued"] else "recompute")
            rec["path"] = path
            rec["src"] = ei
            self._fr.emit("fail", h.router_id, self._step_idx,
                          engine=ei, fault=fault, **textra)
            if not self.failover or h.retries >= self.retry_budget:
                if rec["parcel"] is not None:
                    self._stage.drop(rec["parcel"]["skey"])
                h._unbind(rec["tokens"])
                h._terminate("failed", now)
                self._m.failover_failed.inc()
                self._fr.emit("fail", h.router_id, self._step_idx,
                              engine=ei, fault=fault, terminal=1,
                              retries=h.retries, **textra)
                out.append(h)
                continue
            h.retries += 1
            self._m.failover_requests.inc(path=path)
            h._unbind([] if path == "requeue" else rec["tokens"])
            if path != "requeue":
                h._replay = list(rec["tokens"])
            self._recover.append(rec)
        if self.failover:
            self._place_recoveries(now)

    def _place_recoveries(self, now: float):
        """Place every pending recovery on a healthy replica — the
        unified re-admission path for all three failover routes.
        ``migrate`` hands the parcel to the destination's host tier
        (``HostTier.put``, reason preempt) and parks the request on
        its swap list via ``ServingEngine.migrate_in``; ``recompute``
        and ``requeue`` re-enter the destination queue cold, with the
        victim's PRNG base key carried so replayed streams are
        bit-identical.  A destination refusing with ``AdmissionError``
        spills to the next candidate; when every routable replica
        refuses, the record waits for the next step."""
        if not self._recover:
            return
        pending, self._recover = self._recover, []
        for rec in pending:
            h = rec["handle"]
            # phase-aware destination set: a decode-phase parcel can
            # only resume on a decode-capable replica; prefill-phase
            # parcels and the recompute/requeue paths re-run prompt
            # chunks, so they need a prefill-capable one
            need = ("decode" if rec["parcel"] is not None
                    and rec["parcel"]["phase"] == "decode"
                    else "prefill")
            order, _meta = self._choose(h, phase=need)
            placed = False
            for ei in order:
                eng = self._engines[ei]
                kw = dict(h._kw)
                if rec["path"] != "requeue":
                    # already admitted once: the queue-delay SLO does
                    # not restart (once admitted, a request
                    # always runs to completion)
                    kw["max_queue_delay_s"] = None
                parcel = None
                key = None
                if rec["path"] == "migrate":
                    p = rec["parcel"]
                    key = self._stage.transfer(p["skey"],
                                               eng._host_tier)
                    parcel = {"key": key, "n_blocks": p["n_blocks"],
                              "tok": p["tok"], "lens": p["lens"],
                              "phase": p["phase"],
                              "pf_pos": p["pf_pos"]}
                try:
                    req = eng.migrate_in(
                        h._ids, **kw, samp_base=rec["samp_base"],
                        tokens=(rec["tokens"]
                                if rec["path"] == "migrate" else ()),
                        first_token_time=rec["first_token_time"],
                        parcel=parcel)
                except AdmissionError:
                    if key is not None:
                        rec["parcel"]["skey"] = eng._host_tier.transfer(
                            key, self._stage)
                    continue
                except BaseException:
                    if key is not None:
                        rec["parcel"]["skey"] = eng._host_tier.transfer(
                            key, self._stage)
                    self._recover.append(rec)
                    raise
                h._bind(ei, req)
                self._by_engine[(ei, req.request_id)] = h
                if rec["path"] == "migrate":
                    nb = int(rec["parcel"]["n_blocks"])
                    self._m.migrate_blocks.inc(nb)
                    self._m.migrate_bytes.inc(
                        nb * eng.block_len * eng._kv_row_bytes)
                    self._fr.emit(
                        "migrate", h.router_id, self._step_idx,
                        engine=ei, src=rec["src"], blocks=nb,
                        rid=req.request_id)
                else:
                    self._fr.emit(
                        "retry", h.router_id, self._step_idx,
                        engine=ei, path=rec["path"],
                        attempt=h.retries, rid=req.request_id)
                placed = True
                break
            if not placed:
                self._recover.append(rec)

    # -- disaggregation: chunk-final handoff orchestration --
    def _collect_handoffs(self, ei: int):
        """Pick up every request replica ``ei`` staged at chunk-final
        (``ServingEngine.take_handoffs``): move its KV parcel into the
        router-owned staging tier — EXACTLY the failover migration
        staging, the parcel is preempt-reason host bytes either way —
        unbind the handle (its emitted ``tok0`` becomes the handle's
        own truth, so the stream view stays monotonic while the
        request is between replicas) and queue the placement record.
        No retry-budget charge: a handoff is scheduled work, not a
        fault."""
        eng = self._engines[ei]
        take = getattr(eng, "take_handoffs", None)
        if take is None:
            return
        for req in take():
            h = self._by_engine.pop((ei, req.request_id), None)
            if h is None:
                continue        # router never saw it (direct submit)
            skey = eng._host_tier.transfer(req.swap.host_key,
                                           self._stage)
            upd = getattr(eng, "_update_host_gauge", None)
            if upd is not None:        # local engines only; a remote
                upd()                  # proxy's server updates its own
            rec = {
                "handle": h,
                "samp_base": (None if req.samp_base is None
                              else np.array(req.samp_base)),
                "tokens": [int(x) for x in req.tokens],
                "first_token_time": req.first_token_time,
                "src": ei,
                "parcel": None if skey is None else {
                    "skey": skey,
                    "n_blocks": req.swap.n_blocks,
                    "tok": req.swap.tok, "lens": req.swap.lens,
                    "phase": "decode",
                    "pf_pos": req.pf_pos,
                },
            }
            h._unbind(rec["tokens"])
            h._replay = list(rec["tokens"])
            if rec["parcel"] is None:
                # parcel unreachable (a remote proxy whose staging
                # never landed): recover like a failover recompute —
                # the position-keyed PRNG replays tok0 bit-identically
                rec["path"] = "recompute"
                rec["was_queued"] = False
                self._recover.append(rec)
                continue
            self._handoffs.append(rec)

    def _place_handoffs(self, now: float):
        """Place every staged handoff on a decode-capable replica:
        stage-tier parcel -> destination host tier
        (``HostTier.transfer``) -> ``migrate_in`` parks it on the
        destination's swap list, where ``_try_resume`` re-scatters the
        exact bytes and decode continues token-for-token (the
        ``tok0``/``seq_len`` carries travel in the parcel).  A
        destination refusing with ``AdmissionError`` spills to the
        next candidate; when every decode-capable replica refuses,
        the record waits for the next step — parcels are host bytes,
        waiting costs nothing but latency."""
        if not self._handoffs:
            return
        pending, self._handoffs = self._handoffs, []
        for rec in pending:
            h = rec["handle"]
            if h.state in TERMINAL_STATES:
                # cancelled while awaiting placement; the parcel was
                # already dropped by cancel()
                continue
            order, _meta = self._choose(h, phase="decode")
            placed = False
            for ei in order:
                eng = self._engines[ei]
                kw = dict(h._kw)
                # already admitted once (once admitted, a
                # request always runs to completion)
                kw["max_queue_delay_s"] = None
                p = rec["parcel"]
                key = self._stage.transfer(p["skey"], eng._host_tier)
                parcel = {"key": key, "n_blocks": p["n_blocks"],
                          "tok": p["tok"], "lens": p["lens"],
                          "phase": p["phase"], "pf_pos": p["pf_pos"]}
                try:
                    req = eng.migrate_in(
                        h._ids, **kw, samp_base=rec["samp_base"],
                        tokens=rec["tokens"],
                        first_token_time=rec["first_token_time"],
                        parcel=parcel)
                except AdmissionError:
                    rec["parcel"]["skey"] = eng._host_tier.transfer(
                        key, self._stage)
                    continue
                except BaseException:
                    rec["parcel"]["skey"] = eng._host_tier.transfer(
                        key, self._stage)
                    self._handoffs.append(rec)
                    raise
                h._bind(ei, req)
                self._by_engine[(ei, req.request_id)] = h
                self._fr.emit(
                    "handoff", h.router_id, self._step_idx,
                    engine=ei, src=rec["src"],
                    blocks=int(p["n_blocks"]), rid=req.request_id)
                placed = True
                break
            if not placed:
                self._handoffs.append(rec)

    def _probe_replicas(self, now: float):
        """Probe due unhealthy replicas: a tiny 1-token request driven
        to completion on the candidate alone.  Pass -> the replica
        rejoins the routing set on PROBATION (a fault-free probation
        window then promotes it to healthy); fail -> it stays out and
        the probe backs off by ``probe_interval`` steps."""
        for ei, st in enumerate(self._health):
            if st != "unhealthy" or \
                    self._step_idx < self._next_probe[ei]:
                continue
            eng = self._engines[ei]
            ok = False
            probe = None
            try:
                if self._roles[ei] == "decode":
                    # a decode-role replica rejects fresh submits by
                    # POLICY, so the 1-token probe request could never
                    # pass — probe the crash surface instead: a dead
                    # or poisoned replica faults on step/load_report,
                    # a healthy one answers both
                    eng.step(now)
                    eng.load_report()
                    ok = True
                else:
                    probe = eng.submit(np.zeros((1,), np.int32),
                                       max_new_tokens=1,
                                       arrival_time=now)
                    for _ in range(8):
                        eng.step(now)
                        if probe.state in TERMINAL_STATES:
                            break
                    ok = probe.state == "finished"
            except REPLICA_FAULT_ERRORS:
                eng.crash_reset()
            except AdmissionError:
                pass        # full queue = failed probe, not a crash
            if not ok and probe is not None and \
                    probe.state not in TERMINAL_STATES:
                # a probe that stalled non-exceptionally must not be
                # left queued/active: each retry would stack another
                # live request onto the sick replica until its own
                # bounded queue starts refusing (after crash_reset
                # the probe is already stripped — cancel is a no-op)
                eng.cancel(probe.request_id)
            if ok:
                self._m.probes.inc(outcome="pass")
                self._m.readmissions.inc()
                self._set_health(ei, "probation")
                self._probation_until[ei] = (self._step_idx
                                             + self.probation_steps)
            else:
                self._m.probes.inc(outcome="fail")
                self._next_probe[ei] = (self._step_idx
                                        + self.probe_interval)

    def _verify_replay(self, h: RoutedRequest):
        """The retried-stream determinism contract, checked at the
        recovered finish: the replayed output must start with exactly
        the tokens the victim had already emitted — anything else
        means a reader saw tokens the final stream disowns, which is
        corruption, not recovery."""
        if not h._replay or h._req is None:
            return
        live = h._req.tokens
        k = min(len(h._replay), len(live))
        if list(live[:k]) != h._replay[:k]:
            raise RuntimeError(
                f"failover replay diverged for request "
                f"{h.router_id}: emitted prefix {h._replay[:k]} vs "
                f"replayed {list(live[:k])} — the deterministic-"
                f"recovery contract is broken")
        h._replay = []

    # -- scheduling --
    def step(self, now: Optional[float] = None) -> List[RoutedRequest]:
        """One front-door iteration: sweep router-held queue-delay
        timeouts, probe unhealthy replicas / place pending failover
        recoveries, route every arrived router-held request, then
        step each routable replica once — a replica-fatal raise
        (kill / poisoned dispatch / permanent stall) triggers
        failover instead of propagating.  Returns the handles that
        reached a terminal state this iteration (router timeouts,
        exhausted-budget ``failed`` terminals, and every replica's
        finished/timed-out requests)."""
        self._step_idx += 1
        t_now = self._clock() if now is None else now
        out: List[RoutedRequest] = []
        if self._orphan_terminals:        # swept during a submit()
            out.extend(self._orphan_terminals)
            self._orphan_terminals = []
        self._sweep_timeouts(t_now, out)
        if self.failover:
            self._probe_replicas(t_now)
            self._place_recoveries(t_now)
        self._place_handoffs(t_now)
        self._route_arrived(t_now)
        for ei, e in enumerate(self._engines):
            if self._health[ei] == "unhealthy":
                continue
            try:
                stepped = e.step(t_now)
            except REPLICA_FAULT_ERRORS as err:
                self._fail_over(ei, err, t_now, out)
                continue
            self._collect_handoffs(ei)
            for req in stepped:
                h = self._by_engine.get((ei, req.request_id))
                if h is not None:
                    self._verify_replay(h)
                    out.append(h)
            if self._health[ei] == "probation" and \
                    self._step_idx >= self._probation_until[ei]:
                self._set_health(ei, "healthy")
        # same-step placement: a chunk-final collected from a
        # prefill replica this iteration lands on its decode replica
        # before the step returns, so disaggregation costs at most
        # one router step of handoff latency, never a full spin
        self._place_handoffs(t_now)
        if self._monitor is not None:
            self._monitor.observe(
                step=self._step_idx,
                registries=[e.metrics_registry
                            for e in self._engines],
                health=self._health, queue_depth=len(self._queue),
                max_queue=self.max_queue)
        if self._ts is not None:
            self._ts.sample(self._step_idx)
        return out

    def _idle(self) -> bool:
        """No replica holds queued/active/swapped work and no
        failover recovery or chunk-final handoff awaits placement."""
        if self._recover or self._handoffs:
            return False
        for e in self._engines:
            rep = e.load_report()
            if rep["queue_depth"] or rep["active_slots"] \
                    or rep["swapped_waiting"]:
                return False
        return True

    def _stall_diagnosis(self, wall_timeout_s: float) -> str:
        now = self._clock()
        per = ", ".join(
            f"e{i}(q={r['queue_depth']} act={r['active_slots']} "
            f"free={r['blocks_free']})"
            for i, r in enumerate(e.load_report()
                                  for e in self._engines))
        return (f"router loop exceeded wall_timeout_s={wall_timeout_s} "
                f"without draining: router-held={len(self._queue)} "
                f"(arrived={sum(p.arrival_time <= now for p in self._queue)}), "
                f"recoveries pending={len(self._recover)}, "
                f"handoffs pending={len(self._handoffs)}, "
                f"health={self._health}, replicas: {per}")

    def run(self, max_iters: Optional[int] = None,
            wall_timeout_s: Optional[float] = None
            ) -> List[RoutedRequest]:
        """Drain the front door: route/step until every submitted
        request is terminal.  Mirrors ``ServingEngine.run`` — idle
        sleeps ahead of future arrivals, ``wall_timeout_s`` turns a
        wedged fleet into a diagnosable ``EngineStalledError``.
        Returns this call's terminal handles in router-submission
        order."""
        finished: List[RoutedRequest] = []
        iters = 0
        start = self._clock()
        while self._queue or not self._idle():
            now = self._clock()
            if wall_timeout_s is not None and \
                    now - start > wall_timeout_s:
                raise EngineStalledError(
                    self._stall_diagnosis(wall_timeout_s))
            if self._idle() and self._queue:
                next_arrival = min(p.arrival_time for p in self._queue)
                if next_arrival > now:
                    time.sleep(min(0.005, next_arrival - now))
                    continue
            n_before = len(finished)
            finished.extend(self.step(now))
            if len(finished) == n_before and self._idle():
                # arrived work that no replica would take (bounded
                # engine queues, pool pressure): nap, don't hot-spin
                time.sleep(0.001)
            iters += 1
            if max_iters is not None and iters > max_iters:
                busy = sum(e.load_report()["active_slots"] > 0
                           for e in self._engines)
                raise RuntimeError(
                    f"router loop exceeded max_iters={max_iters} with "
                    f"{len(self._queue)} router-held requests and "
                    f"{busy} busy replicas")
        return sorted(finished, key=lambda h: h.router_id)

    # -- introspection --
    def stats(self) -> dict:
        """Router-level counter deltas plus one ``load_report()``
        snapshot per replica."""
        return {
            "engines": len(self._engines),
            "affinity": self.affinity,
            "requests": int(self._m.since_init(self._m.requests)),
            "routed_by_reason": {
                reason: int(self._m.routed_since(reason))
                for reason in ROUTE_REASONS},
            "prefix_affinity_tokens": int(
                self._m.since_init(self._m.prefix_tokens)),
            "adapter_affinity_hits": int(
                self._m.since_init(self._m.adapter_hits)),
            "shed": int(self._m.since_init(self._m.shed)),
            "timeouts": int(self._m.since_init(self._m.timeouts)),
            "cancelled_router": int(
                self._m.cancelled.value(phase="router")
                - self._m._cancel_base),
            "queue_depth": len(self._queue),
            # failover health + recovery accounting
            "failover": self.failover,
            "health": list(self._health),
            "recoveries_pending": len(self._recover),
            # disaggregation: per-replica phase roles plus
            # chunk-final handoffs awaiting a decode-capable slot
            "roles": list(self._roles),
            "handoffs_pending": len(self._handoffs),
            "replica_faults": int(
                self._m.since_init(self._m.replica_faults)),
            "failover_requests": int(
                self._m.since_init(self._m.failover_requests)),
            "failed": int(
                self._m.since_init(self._m.failover_failed)),
            "probes": int(self._m.since_init(self._m.probes)),
            "readmissions": int(
                self._m.since_init(self._m.readmissions)),
            "migrated_blocks": int(
                self._m.since_init(self._m.migrate_blocks)),
            "migrated_bytes": int(
                self._m.since_init(self._m.migrate_bytes)),
            "per_engine": [e.load_report() for e in self._engines],
            # light fleet-plane summary (the full merged view is
            # fleet_snapshot() — embedding it here would make stats()
            # O(registry) and recursive through snapshot consumers)
            "fleet": {
                "monitor": self._monitor is not None,
                "timeseries": self._ts is not None,
                "alerts": (len(self._monitor.alerts())
                           if self._monitor is not None else 0),
            },
        }

    def fleet_snapshot(self) -> dict:
        """The whole fleet as ONE replica-labeled dict: every
        replica's registry snapshot merged under a ``replica=<i>``
        label (shared registries deduplicate to a ``"+"``-joined
        replica value), health states, ``load_report()``s, the
        router's own stats, and — when attached — the monitor's
        alert/burn-rate summary and the time-series window
        aggregates.  Pure data (JSON-ready): ``tools/serving_top.py``
        renders it without a live engine."""
        self._m.fleet_snapshots.inc()
        # dedupe shared registries: each distinct registry is merged
        # once, labeled with every replica index it serves.  Identity
        # is the registry's stable ``dedupe_key`` when it has one —
        # under remote replicas every snapshot fetch materializes a
        # FRESH shim/dict, so ``id()`` would split one shared server
        # registry into N "distinct" ones and double-count its
        # counters; ``id()`` stays as the fallback
        # for bare registries that predate the key
        by_reg: dict = {}
        for i, e in enumerate(self._engines):
            reg = e.metrics_registry
            key = getattr(reg, "dedupe_key", None) or id(reg)
            by_reg.setdefault(key, [reg, []])[1].append(str(i))
        pairs = [("+".join(idxs), reg.snapshot())
                 for reg, idxs in by_reg.values()]
        snap = {
            "version": 1,
            "step": self._step_idx,
            "engines": len(self._engines),
            "health": list(self._health),
            "registries": obs_fleet.merge_registry_snapshots(pairs),
            "load_reports": [e.load_report() for e in self._engines],
            # per-replica shard-group identity: "single" for
            # plain engines, the mesh label ("tp2@d0", "rep@d4") for
            # shard groups — the fleet's data-parallel topology at a
            # glance, same order as load_reports/health
            "shard_groups": [
                (sg["label"] if (sg := getattr(e, "shard_group",
                                               None)) is not None
                 else "single") for e in self._engines],
            # per-replica phase roles: "both" for monolithic
            # replicas, "prefill"/"decode" under disaggregation —
            # same order as load_reports/health
            "roles": list(self._roles),
            "router": self.stats(),
        }
        # per-replica transport counters: None for local
        # engines, deterministic frame/byte totals for remote proxies
        # — same order as load_reports/health
        tstats = [getattr(e, "transport_stats", None)
                  for e in self._engines]
        if any(t is not None for t in tstats):
            snap["transport"] = [None if t is None else t()
                                 for t in tstats]
        if self._monitor is not None:
            snap["monitor"] = self._monitor.summary()
        if self._ts is not None:
            snap["timeseries"] = self._ts.aggregates()
        return snap

    @property
    def health(self) -> List[str]:
        """Per-replica health states (``HEALTH_STATES``), by index."""
        return list(self._health)

    @property
    def engines(self) -> List[ServingEngine]:
        return list(self._engines)

    @property
    def flight_recorder(self) -> FlightRecorder:
        return self._fr

    @property
    def monitor(self):
        """The attached ``SLOBurnRateMonitor`` (None when absent)."""
        return self._monitor

    @property
    def timeseries(self):
        """The attached ``TimeSeriesRecorder`` (None when absent)."""
        return self._ts

    def stitched_record(self):
        """One fleet-wide :class:`~paddle_tpu_torch.observability.fleet.
        StitchedRecord` over the router's recorder and every
        replica's — the cross-replica ``explain()`` / Perfetto-export
        surface."""
        return obs_fleet.stitch_flight_records(
            [e.flight_recorder for e in self._engines],
            router=self._fr)

    def explain(self, router_id: int) -> str:
        """The router-level lifecycle of one request ("routed to
        engine 1 (prefix affinity 384 tokens)") from the router's
        flight recorder; engine-side detail lives in the owning
        replica's own recorder."""
        return self._fr.explain(router_id)
