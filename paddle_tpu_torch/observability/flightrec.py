"""Per-request flight recorder: a bounded ring of structured lifecycle
events answering "why was THIS request slow".  A copy of
``paddle_tpu/observability/flightrec.py`` (standard library only); its
export is byte-compatible with the JAX package's, so either package's
``load_flight_record`` and ``tools/explain_request.py`` read it.

The metrics registry aggregates — when one request's TTFT blows
up it can say the fleet preempted 14 times, but not that *this*
request waited 3 steps behind request 7, was preempted at step 12 and
resumed via 6 host-RAM blocks.  The flight recorder keeps that
per-request story: every ``ServingEngine`` lifecycle transition emits
one structured event (kind + request id + scheduler step + attrs) into
a bounded ring buffer; ``timeline()`` filters one request's events,
``explain()`` renders them as one human-readable sentence, and
``chrome_events()`` re-encodes the ring as HostTracer-style event
tuples (one lane per request) that ``merge_chrome_traces`` stitches
into the same Perfetto file as the host spans and the device dump.

Design constraints (mirrors ``observability.metrics``):

- **near-zero cost when disabled** — ``emit()`` starts with one
  attribute load + bool test; kind validation, timestamping and the
  ring append happen only on the enabled path (mislabeled kinds
  surface on enable, the ``_resolve_labels`` argument).
- **bounded** — the ring is a ``deque(maxlen=capacity)``: overflow
  drops the OLDEST events (the newest tail is what an incident
  investigation needs) and ``dropped`` counts the loss so an export
  is never silently partial.
- **deterministic modulo wall time** — every field except ``wall`` is
  derived from scheduler state, never from the clock, so two replays
  of one trace produce identical event sequences (the determinism
  contract tests assert; attrs must never carry wall-derived values).

The export format (``export()``/``load_flight_record``) is plain JSON
so ``tools/explain_request.py`` can post-mortem a record from another
process with no framework import beyond this module.
"""

from __future__ import annotations

import json
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .spans import format_span_name

# the closed vocabulary of lifecycle transitions a ServingEngine emits;
# emit() rejects anything else so a typo'd kind cannot silently create
# a parallel event stream no consumer (explain, the CLI) knows about
EVENT_KINDS = frozenset({
    "submit",         # accepted into the queue
    "route",          # router chose an engine replica (engine, affinity,
    #                   policy — emitted by Router, not the engine)
    "admit",          # queue -> slot (prefill starts after mapped blocks)
    "prefix_hit",     # admission mapped cached blocks (tier=hbm|host|partial)
    "prefill_chunk",  # one chunked-prefill dispatch for this request
    "decode_block",   # this request rode one decode-block dispatch
    "spec_verify",    # one verify forward's accept/reject outcome (per slot)
    "preempt",        # swapped out to the host-RAM tier mid-flight
    "swap_out",       # KV blocks left HBM (reason=preempt|cache)
    "swap_in",        # KV blocks re-entered HBM (reason=preempt|cache)
    "shed",           # displaced from a full bounded queue
    "timeout",        # queue wait exceeded max_queue_delay_s
    "cancel",         # dropped by cancel() (attrs carry the phase)
    "finish",         # retired normally (EOS or budget)
    "fail",           # the request's replica failed (attrs: engine,
    #                   fault=kill|poison|stall; terminal=1 + retries
    #                   when the retry budget ran out -> state failed)
    "migrate",        # exact-bytes KV migration to a healthy replica
    #                   (attrs: engine=dest, src, blocks)
    "retry",          # re-placed on a healthy replica (attrs:
    #                   engine=dest, path=recompute|requeue, attempt)
    "handoff",        # disaggregated chunk-final handoff: prefill
    #                   replica -> decode replica through the router
    #                   stage (router event attrs: engine=dest, src,
    #                   blocks, rid; engine event attrs: blocks,
    #                   reason — same parcel, two vantage points)
    "alert",          # fleet monitor alarm (observability.fleet
    #                   SLOBurnRateMonitor): attrs carry kind
    #                   (ALERT_KINDS) + deterministic context; request
    #                   is ENGINE_EVENT — an alert is fleet-scoped, and
    #                   riding the recorder makes it replay-deterministic
})

# request id recorded for engine-scoped events (prefix-cache demotions
# happen on behalf of the POOL, not of one request)
ENGINE_EVENT = -1


@dataclass
class FlightEvent:
    """One lifecycle event.  ``seq`` is the recorder-global monotonic
    index (total order of emission), ``step`` the engine scheduler
    iteration it happened in, ``wall`` the recorder clock at emission —
    the ONE field excluded from determinism comparisons."""
    seq: int
    step: int
    request: int
    kind: str
    wall: float
    attrs: Dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {"seq": self.seq, "step": self.step,
                "request": self.request, "kind": self.kind,
                "wall": self.wall, "attrs": dict(self.attrs)}


class FlightRecorder:
    """Bounded ring of ``FlightEvent``s plus the query/export surface.

    One recorder per engine (pass ``flight_recorder=`` to
    ``ServingEngine``; the engine's default is a DISABLED instance so
    the emit sites stay uniform at the one-bool-test cost).  Not
    thread-safe by design: the serving scheduler is single-threaded
    and every emit site runs on it.
    """

    def __init__(self, capacity: int = 8192, enabled: bool = True,
                 clock=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._enabled = bool(enabled)
        self._clock = clock if clock is not None else time.perf_counter
        self._clock_explicit = clock is not None
        self._ring: deque = deque(maxlen=self.capacity)
        self._seq = 0
        self.dropped = 0

    def bind_clock(self, clock):
        """Adopt the owning engine's clock UNLESS this recorder was
        constructed with an explicit one — so event wall times and the
        engine's request arrival/finish times share one time base even
        for a user-constructed recorder (a replay/fake engine clock
        included), while a deliberately different recorder clock is
        respected."""
        if not self._clock_explicit:
            self._clock = clock

    # -- lifecycle --
    def enable(self):
        self._enabled = True

    def disable(self):
        """Freeze the recorder: ``emit`` becomes one attribute load +
        bool test (the same <2% decode-loop contract as a disabled
        MetricsRegistry)."""
        self._enabled = False

    @property
    def enabled(self) -> bool:
        return self._enabled

    # -- recording --
    def emit(self, kind: str, request: int, step: int, /, **attrs):
        # positional-only core so attrs may reuse the names (the fleet
        # monitor's "alert" events carry a kind= attr)
        if not self._enabled:
            return
        if kind not in EVENT_KINDS:
            raise ValueError(
                f"unknown flight-recorder event kind {kind!r} — known "
                f"kinds: {sorted(EVENT_KINDS)}")
        if len(self._ring) == self.capacity:
            self.dropped += 1          # deque drops the oldest on append
        self._ring.append(FlightEvent(
            self._seq, int(step), int(request), kind, self._clock(),
            attrs))
        self._seq += 1

    # -- queries --
    def events(self) -> List[FlightEvent]:
        return list(self._ring)

    def timeline(self, request_id: int) -> List[FlightEvent]:
        """This request's events, in emission order."""
        return [e for e in self._ring if e.request == request_id]

    def request_ids(self) -> List[int]:
        return sorted({e.request for e in self._ring
                       if e.request != ENGINE_EVENT})

    def explain(self, request_id: int) -> str:
        return explain_events(
            FlightRecord(self._ring, dropped=self.dropped,
                         capacity=self.capacity), request_id)

    # -- export --
    def export(self, path: str) -> dict:
        """Write the ring as JSON; ``dropped`` records how many events
        overflowed out of the ring, so a consumer can tell a complete
        record from a tail.  Returns the written header."""
        header = {"version": 1, "capacity": self.capacity,
                  "dropped": self.dropped, "n_events": len(self._ring)}
        with open(path, "w") as f:
            json.dump({**header,
                       "events": [e.as_dict() for e in self._ring]}, f)
        return header

    def chrome_events(self) -> list:
        """The ring as HostTracer-style event tuples ``(kind, t0, t1,
        tid, value, name)`` — instants on tid = request id (one
        Perfetto lane per request; engine-scoped events ride lane -1),
        attrs ``;k=v``-encoded into the name exactly like ``span()``
        does, so ``merge_chrome_traces(out, host=rec.chrome_events())``
        decodes them into Perfetto args.  Times convert from the
        recorder clock (seconds) to the tracer's ns."""
        out = []
        for e in self._ring:
            t = int(e.wall * 1e9)
            name = format_span_name(
                f"flightrec.{e.kind}", {"request": e.request,
                                        "step": e.step, **e.attrs})
            out.append((1, t, t, e.request, 0, name))
        return out

    def export_chrome_trace(self, out_path: str, host=None,
                            device_trace_dir: Optional[str] = None
                            ) -> dict:
        """One-call Perfetto export: the flight-recorder lanes plus
        optional host-tracer events (a list of event tuples) and the
        torch profiler's chrome export, through ``merge_chrome_traces``."""
        from .spans import merge_chrome_traces
        events = self.chrome_events() + list(host or [])
        return merge_chrome_traces(out_path, host=events,
                                   device_trace_dir=device_trace_dir)


def events_from_record(record: dict) -> List[FlightEvent]:
    """The event list of an already-parsed export dict — the shared
    decoder behind ``load_flight_record`` and consumers that need the
    header too (the CLI reads ``dropped``) without parsing twice."""
    return [FlightEvent(e["seq"], e["step"], e["request"], e["kind"],
                        e["wall"], dict(e.get("attrs", {})))
            for e in record.get("events", [])]


class FlightRecord(list):
    """The loaded form of an export: a plain event list (full ``list``
    behavior, so every pre-existing consumer indexes/iterates it
    unchanged) that ALSO round-trips the export header — most
    importantly ``dropped``.  A stitched fleet story must know when a
    replica's ring overflowed: its missing early events are HOLES, not
    absence, and ``explain_events`` warns instead of narrating a
    partial lifecycle as if it were whole."""

    def __init__(self, events=(), *, dropped: int = 0,
                 capacity: Optional[int] = None, version: int = 1):
        super().__init__(events)
        self.dropped = int(dropped)
        self.capacity = capacity
        self.version = int(version)


def load_flight_record(path: str) -> FlightRecord:
    """Inverse of ``FlightRecorder.export``: the event list (attrs as
    plain dicts) in emission order, as a :class:`FlightRecord` carrying
    the header's ``dropped``/``capacity`` alongside."""
    with open(path) as f:
        record = json.load(f)
    return FlightRecord(
        events_from_record(record),
        dropped=int(record.get("dropped", 0)),
        capacity=record.get("capacity"),
        version=int(record.get("version", 1)))


def _plural(n: int, noun: str) -> str:
    return f"{n} {noun}{'' if n == 1 else 's'}"


def explain_events(events: List[FlightEvent], request_id: int) -> str:
    """Render one request's lifecycle as a human-readable sentence —
    "waited 3 steps behind req 7, preempted at step 12, resumed via 6
    host blocks, 9 spec positions rejected".  Works on any event list
    (a live recorder's ring or a loaded export), and uses OTHER
    requests' events too: "behind req 7" is derived from admissions
    that happened between this request's submit and its admit, so the
    recorder needs no extra queue bookkeeping.

    Returns a diagnostic string for unknown ids instead of raising —
    the CLI points this at arbitrary exports, and "not in this record
    (ring dropped N events)" is the honest answer there.  When the
    event list carries a ``dropped`` attribute (a loaded
    :class:`FlightRecord`, or the live recorder via ``explain()``),
    a non-zero drop count is surfaced in the rendering — an
    overflowed ring's story has holes and must say so."""
    dropped = int(getattr(events, "dropped", 0) or 0)
    tl = [e for e in events if e.request == request_id]
    if not tl:
        note = (f"; the ring dropped "
                f"{_plural(dropped, 'oldest event')}" if dropped else "")
        return (f"request {request_id}: no events in this record "
                f"(wrong id, or the ring dropped them)" + note)
    by_kind: Dict[str, List[FlightEvent]] = {}
    for e in tl:
        by_kind.setdefault(e.kind, []).append(e)
    parts: List[str] = []

    sub = by_kind.get("submit", [None])[0]
    admits = by_kind.get("admit", [])
    if sub is not None:
        bits = [f"submitted at step {sub.step}"]
        for k in ("seq_len", "max_new", "priority"):
            if k in sub.attrs:
                bits.append(f"{k}={sub.attrs[k]}")
        parts.append(bits[0] + " (" + ", ".join(bits[1:]) + ")"
                     if len(bits) > 1 else bits[0])
    for rt in by_kind.get("route", []):
        clause = f"routed to engine {rt.attrs.get('engine', '?')}"
        details = []
        aff = int(rt.attrs.get("affinity", 0))
        if aff:
            details.append(f"prefix affinity {aff} tokens")
        if rt.attrs.get("adapter_hit"):
            details.append("adapter resident")
        if "policy" in rt.attrs:
            details.append(f"policy {rt.attrs['policy']}")
        if "reason" in rt.attrs and not details:
            details.append(f"by {rt.attrs['reason']}")
        if details:
            clause += " (" + ", ".join(details) + ")"
        parts.append(clause)
    if admits:
        adm = admits[0]
        clause = f"admitted at step {adm.step} into slot " \
                 f"{adm.attrs.get('slot', '?')}"
        # multi-tenant LoRA serving: which adapter the request decodes
        # through and how far behind its fair share the tenant was at
        # the admission decision (a deterministic token count)
        if "adapter" in adm.attrs:
            clause += f" with adapter {adm.attrs['adapter']}"
        if "tenant" in adm.attrs:
            clause += (f" (tenant {adm.attrs['tenant']}, fair-share "
                       f"deficit {adm.attrs.get('deficit', 0)})")
        if sub is not None:
            waited = adm.step - sub.step
            ahead = sorted({
                e.request for e in events
                if e.kind == "admit" and e.request != request_id
                and (sub.seq < e.seq < adm.seq)})
            # waited == 1 means "admitted at the first step after
            # submission" — only a longer wait (or a queue-jump) is
            # worth a clause
            if waited > 1 or ahead:
                clause = (f"waited {_plural(waited, 'step')}"
                          + (f" behind req "
                             f"{', '.join(str(r) for r in ahead)}"
                             if ahead else "")
                          + f", {clause}")
        parts.append(clause)
    for h in by_kind.get("prefix_hit", []):
        parts.append(
            f"prefix hit ({h.attrs.get('tier', '?')}): "
            f"{_plural(int(h.attrs.get('blocks', 0)), 'cached block')}"
            f" / {h.attrs.get('tokens', 0)} tokens mapped at step "
            f"{h.step}")
    n_chunks = len(by_kind.get("prefill_chunk", []))
    if n_chunks:
        parts.append(f"prefilled in {_plural(n_chunks, 'chunk')}")
    for p in by_kind.get("preempt", []):
        parts.append(
            f"preempted at step {p.step} "
            f"({_plural(int(p.attrs.get('blocks', 0)), 'block')} to "
            f"host, reason={p.attrs.get('reason', '?')})")
    for s in by_kind.get("swap_in", []):
        if s.attrs.get("reason") == "preempt":
            parts.append(
                f"resumed at step {s.step} via "
                f"{_plural(int(s.attrs.get('blocks', 0)), 'host block')}")
        else:
            parts.append(
                f"promoted {_plural(int(s.attrs.get('blocks', 0)), 'host block')} "
                f"at step {s.step} (cache hit)")
    # failover lifecycle (router health model): replica failure, then
    # the recovery path — exact-bytes migration or deterministic
    # recompute/requeue — or the terminal budget exhaustion
    for f in by_kind.get("fail", []):
        if f.attrs.get("terminal"):
            nr = int(f.attrs.get("retries", 0))
            parts.append(
                f"failed terminally at step {f.step} (retry budget "
                f"exhausted after {nr} "
                f"{'retry' if nr == 1 else 'retries'})")
        else:
            parts.append(
                f"replica e{f.attrs.get('engine', '?')} failed under "
                f"{f.attrs.get('fault', '?')} at step {f.step}")
    for mg in by_kind.get("migrate", []):
        parts.append(
            f"failed over to engine {mg.attrs.get('engine', '?')} "
            f"(migrated "
            f"{_plural(int(mg.attrs.get('blocks', 0)), 'block')} "
            f"at exact bytes)")
    for ho in by_kind.get("handoff", []):
        src = ho.attrs.get("src")
        if src is not None:
            # the router's vantage: it knows both endpoints
            parts.append(
                f"prefilled on engine {src}, handed off "
                f"{_plural(int(ho.attrs.get('blocks', 0)), 'block')} "
                f"to engine {ho.attrs.get('engine', '?')} at "
                f"chunk-final")
        else:
            # a single engine's vantage: it only knows it let go
            parts.append(
                f"handed off "
                f"{_plural(int(ho.attrs.get('blocks', 0)), 'block')} "
                f"at chunk-final for decode elsewhere")
    for rt in by_kind.get("retry", []):
        how = ("recomputed from prompt"
               if rt.attrs.get("path") == "recompute"
               else "re-queued")
        parts.append(
            f"failed over to engine {rt.attrs.get('engine', '?')} "
            f"({how}, attempt {rt.attrs.get('attempt', '?')})")
    verifies = by_kind.get("spec_verify", [])
    if verifies:
        rejected = sum(int(v.attrs.get("rejected", 0)) for v in verifies)
        accepted = sum(int(v.attrs.get("accepted", 0)) for v in verifies)
        parts.append(
            f"{_plural(accepted, 'spec position')} accepted / "
            f"{rejected} rejected over "
            f"{_plural(len(verifies), 'verify forward')}")
    blocks_ev = by_kind.get("decode_block", [])
    if blocks_ev:
        clause = f"rode {_plural(len(blocks_ev), 'decode block')}"
        # harvest lag (dispatch-ahead engines): events are stamped
        # with the DISPATCH step; ``lag`` says how many steps later
        # the outputs were forced to host — a deterministic step
        # delta, never wall time
        lags = [int(e.attrs.get("lag", 0)) for e in blocks_ev]
        n_lag = sum(1 for v in lags if v)
        if n_lag:
            # "lag <= K": a depth-S pipeline harvests each dispatch up
            # to S steps after it was enqueued; max(lags) is the
            # deepest deferral this request actually saw
            clause += (f" ({n_lag} harvested dispatch-ahead, lag <= "
                       f"{_plural(max(lags), 'step')})")
        parts.append(clause)
    for kind, verb in (("finish", "finished"), ("timeout", "timed out"),
                       ("shed", "shed"), ("cancel", "cancelled")):
        for e in by_kind.get(kind, []):
            extra = ""
            if kind == "finish" and "tokens" in e.attrs:
                extra = f" after {_plural(int(e.attrs['tokens']), 'token')}"
            if kind == "cancel" and "phase" in e.attrs:
                extra = f" from phase {e.attrs['phase']}"
            flag = int(e.attrs.get("lag", 0))
            if kind == "finish" and flag:
                # the finish-bitmap poll (dispatch-ahead depth >= 2):
                # the device flipped the row's finish bit inside the
                # dispatch of step N; the host observed it at the
                # deferred harvest, ``lag`` steps later
                parts.append(
                    f"finished on device at step {e.step}, host "
                    f"observed at step {e.step + flag}{extra}")
            else:
                parts.append(f"{verb} at step {e.step}{extra}")
    text = f"request {request_id}: " + "; ".join(parts)
    if dropped:
        text += (f" [ring dropped {_plural(dropped, 'oldest event')} — "
                 f"the early story may have holes]")
    return text
