"""Continuous-batching serving over a paged KV block pool: port of
``paddle_tpu/inference/serving.py`` with its dispatch-ahead step
pipeline, with a
float or int8 KV cache (``kv_cache_dtype="int8"``), float or int8/int4
weights (``weight_dtype=``), per-request sampling and constrained decoding
(``do_sample=``, ``submit(sampling=SamplingParams(...))``: temperature,
top-k, top-p, repetition penalty, token masks), speculative decoding
(``submit(spec_decode=K)`` with an ``NGramDrafter`` or ``ModelDrafter``,
greedy or sampled), preemption to a host-RAM tier, a bounded queue,
cancellation and the tiered radix prefix cache, in any combination; and
the engine half of the fleet layer: token streaming (``submit(
stream=True)`` returns a ``TokenStream``), ``load_report()``,
``crash_reset()``, ``migrate_in()`` and the disaggregation role
(``role="prefill"|"decode"``, the chunk-final handoff and
``take_handoffs()``) that ``inference/router.py`` drives; and
multi-tenant batched LoRA serving with fair-share admission
(``adapter_store=``, ``tenant_weights=``, ``submit(adapter=,
tenant=)``).

Ported: ``AdmissionError`` (:254), ``TERMINAL_STATES`` (:343),
``_block_digests`` (:829), ``BlockPool`` (:859, the digest and the tree
half, ``check()`` included), ``_SwapRecord`` (:1160), ``Request``
(:1181) and ``ServingEngine`` (:1341) with ``submit`` (bounded-queue
shedding, ``max_queue_delay_s``, the radix probe and its rollback),
``cancel`` (:2924), ``_admit`` (:3525: swapped requests resume first in
their class, the radix re-probe, the head-of-line valve, preemption
under pressure), the terminals (``_terminate``, ``_drop_queued``,
``_shed``, ``_sweep_timeouts``), preemption (``_preempt``,
``_preempt_for``, ``_try_resume``), the host tier's synchronous gather,
scatter and demotion (``_gather_rows`` :2210, ``_scatter_rows`` :2235,
``_demote_blocks`` :2260, ``_audit_host_tier`` :2318), the radix
admission (``_probe_radix``, ``_reprobe_radix``, ``_map_radix_span``,
``_residency_rank``), ``_prefill_chunk`` (digest registration and the
radix insert), ``_count_kv_sweep`` (:1813), ``_block_rides`` and
``_decode_tables`` (:4106-4131), ``_spec_verify`` (:4146, with the
sampled accept path :4218-4260), ``_step_inner``, ``_absorb_block``,
``_finish``, ``_release_blocks``, ``run``, ``engine_spec``,
``prefix_match`` and ``stats``.  The fleet half: ``HANDOFF_REASONS`` and
``ENGINE_ROLES`` (:366-374), ``TokenStream`` (:1260), the decode-role
door of ``submit`` (:2395), ``migrate_in`` (:2635), ``crash_reset``
(:2856), the chunk-final branch (:3984), ``_handoff_out`` (:4002),
``take_handoffs`` (:4041) and ``load_report`` (:4890).  The
dispatch-ahead pipeline (``async_dispatch=True``, ``async_depth=S``):
``ASYNC_SYNC_REASONS`` (:324), ``_PendingBlock`` (:1093), ``_LazyStacks``
(:1129),
``_charge_overlap`` (:1948), ``_block_sync_reason`` (:1956),
``_harvest_next`` (:2004), ``_flush_async`` (:2037),
``_reconcile_host_tier`` (:2058), ``_resolve_entries`` (:2080),
``_checked_harvest`` (:2092), ``_absorb_block`` with the re-split of a
fused window (:2119), the lazy demotion (:2260) and the async branch of
``_step_inner`` (:4336) with the fused depth-S windows.  The sampled half:
the engine defaults ``do_sample``/``temperature``/``top_k``/``top_p``
(:1360, :1437), ``Request.sampling`` and ``samp_base`` (:1222),
``submit(sampling=)`` with its validation, the mask's ``begin`` and the
dead-start check (:2332-2560), ``_build_samp`` (:3761, with ``pos_lag``
for deferred dispatches), ``_count_sample_route`` (:3858),
``_mask_dead_end`` (:3873), the single-step clamp of mask rows and the
``mask``/``penalty`` forced syncs (:1990).  The observability half:
``GOODPUT_REASONS`` (:308), ``_ServingInstruments`` (:386, the
fair-share instruments :745-790 included), ``_ledger`` (:1845),
``_slo_account`` (:1900),
every flight-recorder emit site and span, ``stats()`` as per-engine
registry deltas (:4695), ``metrics_registry``, ``flight_recorder`` and
``explain()`` (:4984).  The fault half: ``EngineStalledError``,
``ReplicaKilledError``, ``PoisonedDispatchError`` (:268-291),
``fault_injector=`` with ``_alloc`` (:1938), the poison hook of
``_checked_harvest`` (:2092), the swap-in failure of ``_reprobe_radix``
(:3371), the step's fault block (:4353) and ``run(wall_timeout_s=)``
with ``_stall_diagnosis`` (:4610).  The LoRA and fair-share half: the
store's checks (:1660-1690), ``submit(adapter=, tenant=)`` (:2379-2484)
and ``migrate_in(adapter=, tenant=)`` (:2723-2746), the adapter pin at
admission and resume (:3644-3738, :3255-3300) and its release at
retirement, preemption and ``crash_reset`` (:1928-1933, :2888-2890),
``_build_lora`` (:3830) and the ``lora`` program keys (:4052-4142),
``_fair_norm``, ``_update_deficits`` and ``_charge_tenant``
(:3494-3522), the reorder test of ``_admit`` (:3577-3616, :3731-3738),
the ``stats()`` keys ``tenant_served_tokens``, ``fair_reorders``,
``lora_dispatches`` and ``adapters_resident`` (:4866-4873),
``load_report()["hbm_adapters"]`` and ``engine_spec()["adapters"]``.

The defaults are the reference's: ``async_dispatch=True`` with
``async_depth=1``, ``prefix_cache_mode="radix"`` (with
``enable_prefix_cache=True``), ``enable_preemption=True``,
``host_cache_blocks=4 * num_blocks``, the process-wide metrics registry
and a disabled flight recorder.  On the same trace the port makes the
same decisions (admissions, preemptions, swaps, sheds, timeouts,
dispatch counts, forced syncs, prefix hits) as the JAX engine built the
same way, emits the same flight-recorder events (modulo wall time), and
its host-tier parcels hold the same bytes (a bf16 arena's as the
``uint16`` view of its bits, ``inference/prefixcache.py``).

On the card the decode block runs as a captured CUDA graph, one per
total step count, sampling flag bucket and adapter variant
(``llm.DecodeBlockGraph``; the adapter variant gathers from the store's
arenas inside the graph, over a static ids buffer);
host inputs reach the card from pinned memory (the ``[B, V]`` presence
and bias planes through the engine's pinned staging, straight into the
graph's static planes), and every device output the host reads (a decode
dispatch's tokens and carries, a final chunk's token, a verify's
argmaxes, a host-tier gather) comes back by a non-blocking copy into
pinned memory behind a ``torch.cuda.Event``, the only thing a harvest
waits on.  On the CPU the block runs eagerly.

Features not ported yet take only their off values and raise
``NotImplementedError`` naming the ROADMAP.md item that brings them.
Known differences from the JAX engine: an ``AdapterStore`` takes a
``device`` and must live on the engine's (ROADMAP.md, "Known differences
of LoRA and fair share").
"""

from __future__ import annotations

import hashlib
import time
import weakref
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..device import DeviceLike, dtype_name, resolve_device, to_dtype
from ..models.generation import GenerationConfig, init_paged_kv_arena
from ..observability import metrics as obs_metrics
from ..observability.flightrec import ENGINE_EVENT, FlightRecorder
from ..observability.spans import instant as _span_instant
from ..observability.spans import span as _span
from . import threefry
from .llm import (DecodeBlockGraph, build_swap_in_scatter,
                  build_swap_out_gather, build_weight_quant_plan,
                  chunk_prefill, normalize_weight_dtype, paged_decode_block)
from .prefixcache import (HostTier, RadixPrefixCache, bits_array,
                          parcel_tensor, row_bits)
from .sampling import (MASK_BIAS, NO_FLAGS, SamplingParams, base_key,
                       flags_of, row_planes)
from .speculative import (NGramDrafter, accept_drafts,
                          accept_drafts_sampled, build_spec_verify)

_INF = float("inf")

# the terminal request states: a request in any of these will never emit
# another token ("failed" belongs to the fleet layer's failover; the
# engine itself never assigns it)
TERMINAL_STATES = ("finished", "timeout", "shed", "cancelled", "failed")

# the dispatch-ahead pipeline's closed forced-sync vocabulary: every
# iteration that must bring device outputs to the host EARLY (before the
# next dispatch was enqueued) charges exactly ONE of these
ASYNC_SYNC_REASONS = (
    "eos",          # EOS detection must observe every emitted token
    "budget",       # a rider's token budget can exhaust inside the block
    "mask",         # a token-mask row's host state machine needs the token
    "penalty",      # a repetition-penalty presence plane is host-built
    "spec",         # speculative accept/rollback is a host decision
    "chunk_final",  # a prompt's final chunk samples the first token
    "resume",       # a swap-in rewrites the slot's host carries
    "preempt",      # a swap-out reads the slot's host carries
    "cancel",       # cancel() must know which tokens already exist
    "drain",        # run() is about to raise/hand control to the caller
)


class EngineStalledError(RuntimeError):
    """``run(wall_timeout_s=...)`` exceeded its wall budget without
    draining — the diagnosable form of a wedged scheduler (pool
    exhausted with nothing running, an injected fault, a dispatch that
    never returns).  The message carries the queue / slot / block-pool
    state at the moment of the raise.  ``step()`` also raises it
    directly under an injected PERMANENT stall
    (``FaultInjector.stall_forever``)."""


class ReplicaKilledError(RuntimeError):
    """The replica died: an injected kill (``FaultInjector.
    kill_at_step``) raised at the top of ``step()``, modeling what a
    multi-process deployment sees as a lost connection to a crashed
    worker.  Host-side request records and host-RAM swap parcels
    survive."""


class PoisonedDispatchError(RuntimeError):
    """A dispatch came back corrupted: the harvest validation found
    token ids outside the model vocabulary — the int-token analogue of
    non-finite logits.  Raised BEFORE the corrupt outputs are adopted
    as host truth, so no request's token stream ever carries a
    poisoned value."""


# why a request left a prefill-role replica with its KV parcel instead
# of decoding in place (serving.handoff.requests{reason=}): the only
# trigger is the disaggregation point itself, the prompt's final chunk
HANDOFF_REASONS = ("chunk_final",)

# the role axis of disaggregated serving: "both" is the monolithic
# default (byte-identical to every pre-role trace), "prefill" replicas
# run prompt chunks and hand each request off at its final chunk,
# "decode" replicas only resume migrated parcels (they reject fresh
# submits and never dispatch a prefill chunk)
ENGINE_ROLES = ("prefill", "decode", "both")


# the goodput ledger's closed waste vocabulary: every dispatched
# token-position is either useful or charged to exactly one of these
# (serving.goodput.wasted_tokens{reason=}).  ``recompute_preempt`` is
# structurally ZERO in this engine — preemption swaps exact at-rest
# bytes, never recomputes — and is kept in the vocabulary as the
# ledger's proof of that.
GOODPUT_REASONS = (
    "spec_reject",
    "recompute_preempt",
    "recompute_cache",
    "pad",
)

# sub-ms resolution for the host-vs-dispatch step split: on real
# accelerators the host scheduler slice this histogram isolates is the
# tens-of-microseconds gap the dispatch-ahead pipeline must hide under
# device time
_STEP_BUCKETS = (
    0.00005, 0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
    0.025, 0.05, 0.1, 0.25, 1.0, 5.0,
)


class _ServingInstruments:
    """The engine's registry handles plus per-engine baselines.

    Instruments live in a (usually process-wide) ``MetricsRegistry`` —
    a second engine in the same process shares them — so each engine
    snapshots its counters at construction and ``stats()`` reports the
    delta while the registry keeps the process-wide totals an exporter
    scrapes.  Two sharing caveats: (1) the delta is exact for engines
    used SEQUENTIALLY on one registry; engines running interleaved on
    the same registry see each other's increments — pass each a
    private ``registry=`` for exact isolation; (2) disabling the
    registry freezes the counters, so ``stats()`` stops advancing too
    (the price of stats() being registry-derived).  The names, help
    strings, labels and buckets are the JAX engine's."""

    def __init__(self, registry):
        self.registry = registry
        r = registry
        self.prefills = r.counter(
            "serving.prefills", "prompt prefills completed (requests "
            "that reached their first token)")
        self.prefill_chunks = r.counter(
            "serving.prefill_chunks", "prompt chunks computed (chunked-"
            "prefill dispatches; prefix-cached blocks never become "
            "chunks)")
        self.decode_steps = r.counter(
            "serving.decode_steps", "decode steps executed (block size "
            "x dispatches)")
        self.busy_slot_steps = r.counter(
            "serving.busy_slot_steps",
            "decode step x slot cells holding a live PLAIN-decode "
            "request (spec-mode slots progress via verify forwards, "
            "not decode steps, and are excluded — see serving.spec.*)")
        self.block_dispatches = r.counter(
            "serving.block_dispatches", "compiled decode block calls")
        self.tokens_emitted = r.counter(
            "serving.tokens_emitted", "tokens emitted to requests "
            "(prefill first-tokens + decode-block harvest; "
            "block-granular, so a request hitting EOS mid-block counts "
            "its pad tail — exact only at steps_per_call=1)")
        self.requests_submitted = r.counter(
            "serving.requests_submitted", "requests accepted into the queue")
        self.requests_finished = r.counter(
            "serving.requests_finished", "requests retired (EOS or budget)")
        self.requests_cancelled = r.counter(
            "serving.requests_cancelled",
            "requests dropped by cancel(); the label says which phase "
            "the request was cancelled from (queued / prefill / "
            "decode / swapped)", labels=("phase",))
        self.preempts = r.counter(
            "serving.preempt.requests",
            "in-flight requests preempted (KV blocks swapped to the "
            "host-RAM tier, slot freed) so a higher-class request "
            "could be admitted — or a fault-injection forced swap")
        self.preempt_resumes = r.counter(
            "serving.preempt.resumes",
            "preempted requests re-admitted from the swap list (fresh "
            "blocks allocated, saved bytes re-scattered, decode state "
            "restored)")
        self.swap_out_blocks = r.counter(
            "serving.swap.blocks_out",
            "KV blocks copied out of the arenas into the host-RAM "
            "tier; reason='preempt' at preemption, reason='cache' "
            "when the prefix cache demotes a reclaimed block",
            labels=("reason",))
        self.swap_in_blocks = r.counter(
            "serving.swap.blocks_in",
            "KV blocks re-scattered from the host-RAM tier into "
            "freshly allocated arena rows; reason='preempt' at "
            "resume, reason='cache' at a host-tier prefix hit",
            labels=("reason",))
        self.swap_out_bytes = r.counter(
            "serving.swap.bytes_out",
            "at-rest KV bytes (codes + scale planes for the int8 "
            "cache) swapped out to host RAM, by reason",
            labels=("reason",))
        self.swap_in_bytes = r.counter(
            "serving.swap.bytes_in",
            "at-rest KV bytes swapped back into the arenas, by reason",
            labels=("reason",))
        self.swap_host_blocks = r.gauge(
            "serving.swap.host_blocks",
            "KV blocks currently parked in the host-RAM tier (hwm = "
            "peak footprint in blocks); reason='preempt' = swapped "
            "requests awaiting resume, reason='cache' = demoted "
            "prefix-cache spans", labels=("reason",))
        self.handoff_requests = r.counter(
            "serving.handoff.requests",
            "requests that left a prefill-role replica with their KV "
            "parcel staged for a decode replica instead of decoding "
            "in place, by closed reason vocabulary (HANDOFF_REASONS: "
            "today only 'chunk_final' — the disaggregation point "
            "itself)", labels=("reason",))
        self.handoff_blocks = r.counter(
            "serving.handoff.blocks",
            "KV blocks gathered into handoff parcels at chunk-final "
            "(exact at-rest bytes; the decode replica re-scatters "
            "the same count, so a fleet's migrated-block ledger "
            "balances)")
        self.handoff_bytes = r.counter(
            "serving.handoff.bytes",
            "at-rest KV bytes (codes + scale planes for the int8 "
            "cache) gathered into handoff parcels at chunk-final")
        self.role = r.gauge(
            "serving.role",
            "1 for this engine's disaggregation role ('prefill', "
            "'decode', or the monolithic default 'both'); a fleet "
            "registry's per-label sum counts replicas by role",
            labels=("role",))
        self.shed = r.counter(
            "serving.shed.requests",
            "requests shed by the bounded queue: 'evicted' = a queued "
            "request displaced by a strictly-higher-class arrival, "
            "'rejected' = an arrival refused with AdmissionError",
            labels=("reason",))
        self.timeouts = r.counter(
            "serving.timeout.requests",
            "queued requests finished with status 'timeout' because "
            "their wait exceeded max_queue_delay_s — shed-by-deadline "
            "instead of served-late")
        self.evictions = r.counter(
            "serving.slot_evictions", "slot frees at request retirement")
        self.prefix_hits = r.counter(
            "serving.prefix_hits", "prompt blocks mapped from the prefix "
            "cache at admission instead of being recomputed")
        self.prefix_misses = r.counter(
            "serving.prefix_misses", "matchable prompt blocks that had "
            "to be computed (no cached twin at admission)")
        self.prefix_hit_tokens = r.counter(
            "serving.prefix.hit_tokens",
            "prompt tokens served from the prefix cache at admission "
            "(mapped blocks x block_len — token-granular cache "
            "effectiveness; PR-3's serving.prefix_hits counts whole "
            "blocks only)")
        self.prefix_partial_hits = r.counter(
            "serving.prefix.partial_hits",
            "admissions whose token-level radix match extended past "
            "the last mappable full block (the partial tail was "
            "recomputed — the match lengths the block-aligned digest "
            "cache could not even see)")
        self.prefix_host_hits = r.counter(
            "serving.prefix.host_hits",
            "admissions whose matched span included >= 1 host-RAM-"
            "resident block (served by exact-bytes swap-in instead of "
            "recompute)")
        self.prefix_host_swapin = r.counter(
            "serving.prefix.host_swapin_blocks",
            "blocks promoted host-RAM -> HBM on prefix-cache hits "
            "(the cache-reason slice of serving.swap.blocks_in)")
        self.queue_depth = r.gauge(
            "serving.queue_depth", "requests waiting for a slot")
        self.slot_occupancy = r.gauge(
            "serving.slot_occupancy", "slots holding a live request")
        self.slots_total = r.gauge(
            "serving.slots_total", "KV-cache slot pool size")
        self.blocks_free = r.gauge(
            "serving.blocks_free", "KV block-pool blocks with refcount 0 "
            "(free list + reclaimable prefix-cached)")
        self.blocks_in_use = r.gauge(
            "serving.blocks_in_use", "KV block-pool blocks pinned by "
            "live or queued requests (hwm = high-water mark)")
        self.latency = r.histogram(
            "serving.request_latency_seconds",
            "request latency, arrival -> last token")
        self.ttft = r.histogram(
            "serving.ttft_seconds",
            "time to first token, arrival -> last prefill chunk")
        self.chunk_latency = r.histogram(
            "serving.prefill_chunk_seconds",
            "wall time of one chunked-prefill dispatch (a dispatch-"
            "ahead engine's non-final chunks are pure enqueues, so "
            "only final chunks include compute+materialization there)")
        self.spec_verifies = r.counter(
            "serving.spec.verify_steps", "speculative verify forwards "
            "dispatched (one K+1-position target forward per scheduler "
            "iteration with >= 1 spec-mode slot) — against "
            "serving.block_dispatches this is the plain-vs-speculative "
            "decode route split")
        self.spec_draft_hits = r.counter(
            "serving.spec.draft_hits",
            "drafter proposals that produced >= 1 candidate token")
        self.spec_draft_misses = r.counter(
            "serving.spec.draft_misses", "drafter proposals that came "
            "back empty (the verify degrades to a plain 1-token step "
            "for that slot)")
        self.spec_draft_tokens = r.counter(
            "serving.spec.draft_tokens",
            "candidate tokens proposed by the drafter")
        self.spec_accepted_tokens = r.counter(
            "serving.spec.accepted_tokens", "draft tokens accepted by "
            "the verifier (each saved one target forward)")
        self.spec_accepted_len = r.histogram(
            "serving.spec.accepted_length",
            "accepted draft-prefix length per spec slot per verify "
            "forward (tokens; the +1 correction/bonus emit is not "
            "counted)",
            buckets=(0.0, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0,
                     24.0, 32.0))
        self.sample_sampled_tokens = r.counter(
            "serving.sample.sampled_tokens",
            "tokens emitted by rows with a stochastic sampling config "
            "(temperature > 0 and top_k != 1), across decode blocks, "
            "chunk-final prefills and speculative verifies — against "
            "serving.sample.greedy_tokens this is the engine's "
            "sampled-vs-greedy route split")
        self.sample_greedy_tokens = r.counter(
            "serving.sample.greedy_tokens",
            "tokens emitted by greedy rows (no sampling config, "
            "temperature 0, or top_k=1) — the bit-exact argmax route")
        self.sample_masked_tokens = r.counter(
            "serving.sample.masked_tokens",
            "tokens emitted under an active token-mask constraint "
            "(a per-request TokenMaskProcessor biased the row's "
            "logits this step)")
        self.sample_resamples = r.counter(
            "serving.sample.resamples",
            "residual resamples consumed by stochastic speculative "
            "sampling (one per verify forward whose draft prefix was "
            "cut by the accept test; the residual draw preserves the "
            "output distribution)")
        self.kv_bytes_swept = r.counter(
            "serving.kv.bytes_swept",
            "modeled KV-arena bytes read by decode/verify/prefill-chunk "
            "dispatches, at the paged kernels' block-DMA granularity "
            "(valid prefix rounded up to whole blocks; codes + scale "
            "planes for the int8 cache) — the roofline denominator of "
            "the serving bench's achieved_GBps")
        self.kv_quant_dtype = r.gauge(
            "serving.kv.quant_dtype",
            "1 for each KV-cache at-rest dtype an engine in this "
            "process serves with (the label carries the dtype name)",
            labels=("dtype",))
        self.weights_bytes_swept = r.counter(
            "serving.weights.bytes_swept",
            "modeled model-weight bytes streamed from HBM by decode/"
            "verify/prefill-chunk dispatches: one full weight sweep per "
            "forward (non-quantized params at the compute dtype; "
            "quantized projections at their code width — int8 codes, "
            "packed int4 nibbles — plus f32 scale planes).  The "
            "weight-side twin of serving.kv.bytes_swept and the "
            "roofline denominator of the weight_quant bench arm")
        self.shard_groups = r.gauge(
            "serving.shard.groups",
            "1 per engine serving as a tensor-parallel shard group "
            "over a device mesh, 0 for single-chip engines — a fleet "
            "registry's sum counts its live shard groups")
        self.shard_width = r.gauge(
            "serving.shard.width",
            "kv-head tensor-parallel degree of this engine's paged "
            "arenas (shards per group; 1 = single-chip or the "
            "replicated mesh_geom fallback)")
        self.weights_quant_dtype = r.gauge(
            "serving.weights.quant_dtype",
            "1 for each weight at-rest dtype an engine in this process "
            "serves with — the compute dtype name for full-precision "
            "engines, 'int8'/'int4' for quantized weight planes (the "
            "label carries the dtype name)",
            labels=("dtype",))
        self.goodput_useful = r.counter(
            "serving.goodput.useful_tokens",
            "dispatched token-positions that produced kept work: "
            "first-time prompt prefill positions and emitted output "
            "tokens that survive in the request's final stream; the "
            "tenant label attributes the work to the submitting "
            "tenant ('default' for tenant-less requests)",
            labels=("tenant",))
        self.goodput_wasted = r.counter(
            "serving.goodput.wasted_tokens",
            "dispatched token-positions that produced discarded work, "
            "by reason: 'spec_reject' = rejected/cut speculative draft "
            "positions, 'recompute_preempt' = positions recomputed "
            "after preemption (structurally 0 under exact-bytes swap), "
            "'recompute_cache' = prompt positions the prefix cache "
            "matched token-level but could not map (partial tails, "
            "dropped host parcels, tier-evict holes), 'pad' = grid/"
            "mask padding (chunk-grid tails, post-EOS block tails, "
            "masked verify lanes); the tenant label attributes the "
            "waste to the submitting tenant",
            labels=("reason", "tenant"))
        self.goodput_dispatched = r.counter(
            "serving.goodput.dispatched_tokens",
            "total dispatched token-positions over participating rows "
            "(the _count_kv_sweep convention: vacant/frozen rows are "
            "excluded), per submitting tenant — conservation: useful "
            "+ wasted == this, exactly, by construction of the ledger "
            "helper (and per tenant label too, since every call "
            "charges one tenant)", labels=("tenant",))
        self.tpot = r.histogram(
            "serving.tpot_seconds",
            "per-output-token decode latency, one observation per "
            "finished request with >= 2 output tokens: (last token - "
            "first token) / (n_tokens - 1)")
        self.step_host = r.histogram(
            "serving.step.host_seconds",
            "host-side scheduler time of one step(): step wall minus "
            "the time spent inside compiled dispatches — the lockstep "
            "gap a dispatch-ahead pipeline must hide under device "
            "time (observed only for steps that dispatched work)",
            buckets=_STEP_BUCKETS)
        self.step_dispatch = r.histogram(
            "serving.step.dispatch_seconds",
            "time one step() spent inside compiled dispatches (chunk "
            "prefill, decode block, spec verify, swap gathers/"
            "scatters), including output materialization for sync-"
            "harvested dispatches; a DEFERRED dispatch contributes its "
            "enqueue time here and its materialization wait to "
            "serving.step.overlap_seconds", buckets=_STEP_BUCKETS)
        self.step_overlap = r.histogram(
            "serving.step.overlap_seconds",
            "time spent blocking on a PREVIOUS iteration's in-flight "
            "device outputs — deferred-harvest materialization and "
            "lazy host-tier parcel resolution; one observation per "
            "wait.  This is the slice the dispatch-ahead pipeline "
            "hides under device time: it is excluded from "
            "serving.step.host_seconds, which stays pure "
            "host-scheduler work", buckets=_STEP_BUCKETS)
        self.stall_seconds = r.histogram(
            "serving.fault.stall_seconds",
            "injected fault-stall sleep time (FaultInjector."
            "stall_steps), one observation per stalled step — charged "
            "here so fault-injection runs never pollute the "
            "serving.step.host_seconds baseline the dispatch-ahead "
            "pipeline is judged against", buckets=_STEP_BUCKETS)
        self.async_syncs = r.counter(
            "serving.async.syncs",
            "dispatch-ahead iterations that forced an EARLY harvest "
            "(materialized device outputs before the next dispatch "
            "was enqueued) because host truth was semantically "
            "required, by closed reason vocabulary (ASYNC_SYNC_"
            "REASONS: eos/budget/mask/penalty/spec/chunk_final/"
            "resume/preempt/cancel/drain)", labels=("reason",))
        self.async_harvests = r.counter(
            "serving.async.harvests",
            "deferred harvests completed at the pipeline's natural "
            "point — AFTER the next compiled dispatch was enqueued — "
            "i.e. iterations whose host-scheduler work actually "
            "overlapped device time")
        self.async_depth = r.gauge(
            "serving.async.depth",
            "un-harvested in-flight decode dispatches right now (hwm "
            "= peak pipeline depth reached; bounded by the engine's "
            "async_depth — 1 for the default double-buffered pipeline)")
        self.slo_attained = r.counter(
            "serving.slo.attained",
            "SLO-carrying requests (deadline_s or max_queue_delay_s "
            "set) that finished within their deadline; the class "
            "label is the priority class (p<N>) and the tenant label "
            "the submitting tenant ('default' when unset) — per-"
            "tenant SLO attainment is one exporter group-by away",
            labels=("class", "tenant"))
        self.slo_missed = r.counter(
            "serving.slo.missed",
            "SLO-carrying requests that finished past their deadline "
            "or were shed/timed out before running, by priority "
            "class and submitting tenant; cancelled requests are a "
            "user action, not an SLO outcome, and count in neither",
            labels=("class", "tenant"))
        self.fairshare_served = r.counter(
            "serving.fairshare.served_tokens",
            "tokens of service charged to each tenant at admission "
            "(prompt + decode budget — the reservation the fair-share "
            "layer accounts, charged when the request leaves the "
            "queue) — the deficit-weighted round-robin's ledger",
            labels=("tenant",))
        self.fairshare_deficit = r.gauge(
            "serving.fairshare.deficit",
            "each tenant's fair-share deficit: the most-served "
            "tenant's weight-normalized service minus this tenant's "
            "(>= 0; the largest deficit admits next within a "
            "scheduling class).  0 for every tenant on single-tenant "
            "traces — the fair-share layer is then inert",
            labels=("tenant",))
        self.fairshare_reorders = r.counter(
            "serving.fairshare.reorders",
            "admissions where the deficit-weighted round-robin chose "
            "a candidate that was NOT the FIFO head of the best "
            "scheduling class — each one is a starvation the plain "
            "priority/EDF/FIFO order would have inflicted on the "
            "chosen tenant")
        self._base = {}
        for c in (self.prefills, self.prefill_chunks, self.decode_steps,
                  self.busy_slot_steps, self.block_dispatches,
                  self.requests_finished, self.requests_cancelled,
                  self.prefix_hits, self.prefix_misses,
                  self.spec_verifies, self.spec_draft_hits,
                  self.spec_draft_misses, self.spec_draft_tokens,
                  self.spec_accepted_tokens, self.kv_bytes_swept,
                  self.weights_bytes_swept,
                  self.prefix_hit_tokens, self.prefix_partial_hits,
                  self.prefix_host_hits, self.prefix_host_swapin,
                  self.sample_sampled_tokens, self.sample_greedy_tokens,
                  self.sample_masked_tokens, self.sample_resamples,
                  self.preempts, self.preempt_resumes,
                  self.swap_out_blocks, self.swap_in_blocks,
                  self.swap_out_bytes, self.swap_in_bytes,
                  self.handoff_requests, self.handoff_blocks,
                  self.handoff_bytes,
                  self.shed, self.timeouts,
                  self.goodput_useful, self.goodput_wasted,
                  self.goodput_dispatched,
                  self.async_syncs, self.async_harvests,
                  self.slo_attained, self.slo_missed,
                  self.fairshare_served, self.fairshare_reorders):
            # total() sums label sets, so labeled counters (cancelled
            # by phase, shed by reason) baseline the same way the
            # unlabeled ones do
            self._base[c.name] = c.total()
        # per-reason forced-sync baselines: the reason vocabulary is
        # closed, so stats() reports exact per-engine per-reason
        # deltas on a shared registry the same way since_init does for
        # totals (the per-reason wasted-token breakdown is a host-side
        # mirror in the engine, ServingEngine._wasted_reason: the
        # goodput counters carry the open-vocabulary tenant label)
        self._syncs_base = {reason: self.async_syncs.value(reason=reason)
                            for reason in ASYNC_SYNC_REASONS}

    def syncs_since(self, reason: str) -> float:
        """Per-reason forced-sync delta attributable to THIS engine."""
        return (self.async_syncs.value(reason=reason)
                - self._syncs_base.get(reason, 0))

    def since_init(self, counter) -> float:
        """Counter delta attributable to THIS engine (summed over
        label sets for labeled counters)."""
        return counter.total() - self._base.get(counter.name, 0)


class AdmissionError(RuntimeError):
    """A bounded queue (``ServingEngine(max_queue=N)``) refused an
    arrival: the queue is full and no queued request is of strictly
    lower scheduling class than the new one, so the arrival is shed.
    Typed so callers can degrade (retry, spill to another replica,
    answer 429) instead of matching a message."""

    def __init__(self, msg, *, queue_depth=None, max_queue=None):
        super().__init__(msg)
        self.queue_depth = queue_depth
        self.max_queue = max_queue


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to paddle_tpu_torch yet (ROADMAP.md, "
        f"Queue 1: {item})")


def _block_digests(ids: np.ndarray, n: int, block_len: int,
                   salt: bytes = b"ptpu-paged-kv") -> List[bytes]:
    """Chained blake2b digests of the prompt's FULL blocks: block i's
    digest covers tokens [0, (i+1)*block_len) through the chain, so two
    blocks share a digest only when their whole attention context is
    identical.  ``salt`` seeds the chain (the engine salts with the KV
    cache dtype)."""
    out: List[bytes] = []
    h = salt
    for i in range(n // block_len):
        h = hashlib.blake2b(
            h + ids[i * block_len:(i + 1) * block_len].tobytes(),
            digest_size=16).digest()
        out.append(h)
    return out


def _neg_deadline(deadline: Optional[float]) -> float:
    """Deadline term of the "worseness" ordering: no deadline sorts as
    infinitely late, and later deadlines sort before earlier ones."""
    return -(deadline if deadline is not None else _INF)


class BlockPool:
    """Host-side allocator for the device block arena: a free list over
    ``num_blocks`` logical blocks plus a refcounted prefix cache.

    ``alloc`` hands a block out with refcount 1; ``pin``/``unpin`` move
    the refcount as prefix sharers map it in and requests retire; a
    block whose refcount drops to 0 returns to the free list UNLESS a
    cache index holds it — then it parks, still mapped, and is reclaimed
    only when the free list runs dry.  The arena's extra row ``trash``
    is never allocated.

    Two cache indices can park unpinned blocks: the chained-digest map
    (``register``/``lookup``, ``prefix_cache_mode="digest"``) and the
    radix tree of ``inference/prefixcache.py`` (``tree_hold``/
    ``tree_touch``).  A tree-held block at refcount 0 parks in
    ``_tree_lru``; when ``alloc`` reclaims some, ``reclaim_cb`` (the
    engine's demote path) fires once with the reclaimed list before
    alloc returns — the caller has not written the rows yet, so their
    bytes can still be gathered to the host tier.  ``audit_hooks`` let
    the owning cache fold its own invariants into ``check()``."""

    def __init__(self, num_blocks: int, block_len: int):
        self.num_blocks = int(num_blocks)
        self.block_len = int(block_len)
        self.trash = self.num_blocks           # extra arena row index
        self._free = list(range(self.num_blocks - 1, -1, -1))
        self._ref = [0] * self.num_blocks
        self._digest_of: List[Optional[bytes]] = [None] * self.num_blocks
        self._by_digest = {}                   # digest -> block id
        self._lru: OrderedDict = OrderedDict()  # digest -> block, ref == 0
        self._tree_ref = set()                 # radix-tree-held blocks
        self._tree_lru: OrderedDict = OrderedDict()  # block -> True
        self.reclaim_cb = None                 # fires on tree-LRU reclaim
        self.audit_hooks = []                  # extra check() invariants

    def available(self) -> int:
        """Blocks allocatable right now (free + reclaimable cached)."""
        return len(self._free) + len(self._lru) + len(self._tree_lru)

    def in_use(self) -> int:
        """Blocks pinned by live or queued requests (refcount > 0)."""
        return self.num_blocks - self.available()

    def cached(self) -> int:
        """Unpinned blocks kept mapped for future prefix hits."""
        return len(self._lru) + len(self._tree_lru)

    def lookup(self, digest: bytes) -> Optional[int]:
        return self._by_digest.get(digest)

    def pin(self, block: int):
        if self._ref[block] == 0:
            dg = self._digest_of[block]
            if dg is not None:
                self._lru.pop(dg, None)
            self._tree_lru.pop(block, None)
        self._ref[block] += 1

    def unpin(self, block: int):
        if self._ref[block] <= 0:
            raise RuntimeError(
                f"block {block} unpinned below refcount 0 — double free")
        self._ref[block] -= 1
        if self._ref[block] == 0:
            dg = self._digest_of[block]
            if dg is not None:
                self._lru[dg] = block          # reclaimable, still mapped
            elif block in self._tree_ref:
                self._tree_lru[block] = True   # reclaimable, still mapped
            else:
                self._free.append(block)

    def tree_hold(self, block: int):
        """Mark a block referenced by the radix prefix tree.  The
        caller must hold a pin (registration and promotion both run
        under the owning request's refcount)."""
        if not (0 <= block < self.num_blocks):
            raise RuntimeError(f"tree_hold of non-pool block {block}")
        if self._ref[block] <= 0:
            raise RuntimeError(
                f"tree_hold of unpinned block {block} — registration "
                f"must run under the owning request's refcount")
        self._tree_ref.add(block)

    def tree_touch(self, block: int):
        """LRU-refresh a tree-held reclaimable block on a cache hit."""
        if block in self._tree_lru:
            self._tree_lru.move_to_end(block)

    def register(self, block: int, digest: bytes):
        """Publish a fully-written prompt block for future prefix hits
        (first writer wins)."""
        if digest in self._by_digest:
            return
        self._by_digest[digest] = block
        self._digest_of[block] = digest

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` blocks with refcount 1 each, reclaiming the oldest
        refcount-0 cached blocks when the free list runs dry; None when
        the pool cannot serve ``n``.  Digest-cached blocks unmap;
        tree-held blocks fire ``reclaim_cb`` (once, with the whole
        reclaimed list) before alloc returns, while their bytes are
        intact."""
        if n > self.available():
            return None
        out = []
        reclaimed = []
        for _ in range(n):
            if self._free:
                b = self._free.pop()
            elif self._tree_lru:
                b, _ = self._tree_lru.popitem(last=False)
                self._tree_ref.discard(b)
                reclaimed.append(b)
            else:
                dg, b = self._lru.popitem(last=False)
                del self._by_digest[dg]
                self._digest_of[b] = None
            self._ref[b] = 1
            out.append(b)
        if reclaimed and self.reclaim_cb is not None:
            self.reclaim_cb(reclaimed)
        return out

    def check(self) -> bool:
        """Full invariant audit; raises ``RuntimeError`` listing every
        violation, returns True when clean: free + pinned + cached covers
        every block exactly once; free blocks are unmapped and never
        tree-held; every LRU member has refcount 0 and maps back to
        itself; the digest maps are a bijection; tree-held blocks are
        never digest-mapped and park in the tree LRU at refcount 0; no
        refcount is negative; and every ``audit_hooks`` entry returns no
        errors."""
        errs = []
        free_set = set(self._free)
        if len(free_set) != len(self._free):
            errs.append(f"free list holds duplicates: {self._free}")
        lru_set = set(self._lru.values())
        tlru_set = set(self._tree_lru)
        pinned = 0
        for b in range(self.num_blocks):
            ref = self._ref[b]
            dg = self._digest_of[b]
            cached_here = b in lru_set or b in tlru_set
            if ref < 0:
                errs.append(f"block {b}: negative refcount {ref}")
            if ref > 0:
                pinned += 1
                if b in free_set or cached_here:
                    errs.append(
                        f"block {b}: refcount {ref} but on the "
                        f"{'free list' if b in free_set else 'LRU'}")
            elif not (b in free_set or cached_here):
                errs.append(f"block {b}: refcount 0 but neither free "
                            f"nor cached — leaked")
            if b in free_set and (b in lru_set or b in tlru_set):
                errs.append(f"block {b}: both free and LRU-cached")
            if b in free_set and dg is not None:
                errs.append(f"block {b}: free but still digest-mapped")
            if b in free_set and b in self._tree_ref:
                errs.append(f"block {b}: free but tree-referenced")
            if b in self._tree_ref and dg is not None:
                errs.append(f"block {b}: both tree-referenced and "
                            f"digest-mapped")
            if b in self._tree_ref and ref == 0 and b not in tlru_set:
                errs.append(f"block {b}: tree-referenced at refcount 0 "
                            f"but not in the tree LRU — unreclaimable")
            if b in tlru_set and b not in self._tree_ref:
                errs.append(f"block {b}: in the tree LRU but not "
                            f"tree-referenced")
            if dg is not None and self._by_digest.get(dg) != b:
                errs.append(
                    f"block {b}: digest points at block "
                    f"{self._by_digest.get(dg)} in _by_digest")
        for dg, b in self._by_digest.items():
            if self._digest_of[b] != dg:
                errs.append(f"_by_digest maps {dg.hex()} -> {b} but "
                            f"block {b} carries another digest")
        for dg, b in self._lru.items():
            if self._ref[b] != 0:
                errs.append(f"LRU block {b}: refcount {self._ref[b]}")
            if self._digest_of[b] != dg:
                errs.append(f"LRU digest {dg.hex()} maps block {b} "
                            f"whose digest differs")
        if len(self._free) + pinned + len(self._lru) \
                + len(self._tree_lru) != self.num_blocks:
            errs.append(
                f"conservation: free({len(self._free)}) + "
                f"pinned({pinned}) + cached({len(self._lru)} digest + "
                f"{len(self._tree_lru)} tree) != "
                f"num_blocks({self.num_blocks})")
        for hook in self.audit_hooks:
            errs.extend(hook())
        if errs:
            raise RuntimeError(
                "BlockPool.check failed:\n  " + "\n  ".join(errs))
        return True


@dataclass
class _PendingBlock:
    """One dispatched-but-not-yet-harvested decode dispatch: an entry of
    the pipeline's bounded pending deque (depth 1 = the double buffer).

    ``out`` holds the dispatch's device outputs ``(toks [B, n], tok,
    lens, done, budget)``; on the card they are a CUDA graph's static
    outputs, valid as the NEXT dispatch's carries only (the next replay
    of that graph overwrites them), and ``host`` holds their copies in
    pinned memory, enqueued right after the replay, behind ``event``:
    a harvest waits on the event and reads ``host``, nothing else.  On
    the CPU ``host`` is ``out`` itself and ``event`` is None.  ``done``
    is the in-trace FINISH BITMAP (EOS hit or budget exhausted).

    A FUSED dispatch covers ``iters`` logical iterations of ``per_iter``
    scanned steps each (``n = iters * per_iter``); the harvest re-splits
    it iteration by iteration.  ``pre_lens`` is the host-true per-slot
    lens entering the dispatch (the KV-sweep model needs it);
    ``active``/``reqs`` pin the riding set: a rider that finished in an
    EARLIER pending dispatch rides later in-flight ones frozen on the
    device and is skipped at their harvest."""
    step_idx: int
    n: int                         # scanned steps in this dispatch
    per_iter: int                  # steps per logical iteration
    iters: int                     # logical iterations (n // per_iter)
    active: List[int]              # riding slot indices
    reqs: List["Request"]          # parallel to ``active``
    pre_lens: np.ndarray           # host lens mirror entering dispatch
    out: tuple                     # device (toks, tok, lens, done, budget)
    host: tuple                    # their host copies (pinned on the card)
    event: Optional[object] = None     # torch.cuda.Event after the copies
    slot: Optional[dict] = None        # the pinned ring slot it holds


class _HostStaging:
    """The engine's two page-locked staging buffers for the host copies
    it waits on: a preemption's gather, a swap-in or promotion, a final
    chunk's token, a verify's argmaxes.  Pieces go through them in turn,
    so one buffer's copy runs while the host moves the other's bytes; a
    buffer is rewritten only after the event behind its last copy has
    fired, and grows to the largest piece seen, so after the first
    pieces no copy pays for a fresh page-locked allocation.  On the CPU
    the copies are plain."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self._bufs = [None, None]
        self._events = ([torch.cuda.Event(), torch.cuda.Event()]
                        if self.cuda else [None, None])
        self._held = [None, None]      # (index, host view) awaiting read
        self._next = 0

    def _take(self, t: torch.Tensor, out: List):
        """``(k, view)``: the next buffer ``k``, its last copy run and its
        bytes read into ``out``, as a host view of ``t``'s dtype and
        shape."""
        k = self._next
        self._next ^= 1
        self._events[k].synchronize()
        if self._held[k] is not None:
            i, h = self._held[k]
            out[i] = bits_array(h)
            self._held[k] = None
        nbytes = t.numel() * t.element_size()
        if self._bufs[k] is None or self._bufs[k].numel() < nbytes:
            self._bufs[k] = torch.empty(max(nbytes, 1 << 16),
                                        dtype=torch.uint8, pin_memory=True)
        return k, self._bufs[k][:nbytes].view(t.dtype).view(t.shape)

    def to_host(self, tensors) -> List[np.ndarray]:
        """Device tensors (contiguous) to numpy arrays that own their
        bytes (``bits_array``: int16 bits as ``uint16``)."""
        if not self.cuda:
            return [bits_array(t) for t in tensors]
        out: List = [None] * len(tensors)
        for i, t in enumerate(tensors):
            k, h = self._take(t, out)
            h.copy_(t, non_blocking=True)
            self._events[k].record()
            self._held[k] = (i, h)
        for k in (0, 1):
            if self._held[k] is not None:
                self._events[k].synchronize()
                i, h = self._held[k]
                out[i] = bits_array(h)
                self._held[k] = None
        return out

    def to_device(self, t: torch.Tensor, out: torch.Tensor):
        """Copy the host tensor ``t`` into the device tensor ``out`` (same
        dtype and shape) without blocking the host."""
        if not self.cuda:
            out.copy_(t)
            return
        k, h = self._take(t, [])
        h.copy_(t)
        out.copy_(h, non_blocking=True)
        self._events[k].record()


class _LazyStacks:
    """One deferred demote gather: the gathered row stacks (a copy out
    of the arenas, so later in-place arena writes cannot reach them),
    already on their way to pinned host memory behind ``event``,
    materialized to numpy ONCE on first need.  Shared by every host-tier
    parcel the gather covered: resolving any parcel resolves the
    page."""

    __slots__ = ("_host", "_event", "_np")

    def __init__(self, host, event):
        self._host = list(host)
        self._event = event
        self._np = None

    def resolve(self) -> List[np.ndarray]:
        if self._np is None:
            if self._event is not None:
                self._event.synchronize()
            self._np = [bits_array(h) for h in self._host]
            self._host = self._event = None
        return self._np

    def block_rows(self, j: int) -> List[np.ndarray]:
        """Parcel rows for gathered row ``j``: one ``[1, ...]``
        contiguous slice per flat arena."""
        return [np.ascontiguousarray(s[j:j + 1]) for s in self.resolve()]


@dataclass
class _SwapRecord:
    """A preempted request's device state, parked in the shared
    ``HostTier`` (reason ``"preempt"``): ``host_key`` names the parcel
    holding one ``[n_blocks, ...]`` stack per flat arena (the request's
    real blocks at their exact at-rest bytes); ``tok``/``lens`` are the
    slot's carries at preemption.  With them and the bytes restored, the
    resumed request is bit-identical to one never preempted."""
    host_key: int
    n_blocks: int
    tok: int
    lens: int
    state: str                     # "prefill" | "decode"


@dataclass
class Request:
    """One serving request and its lifecycle accounting.

    ``tokens`` accumulates generated ids; after EOS the stream is
    ``pad_token_id``, and ``output`` is always exactly
    ``max_new_tokens`` long.  ``state`` walks queued -> prefill ->
    decode -> finished, with the overload detours: ``swapped``
    (preempted to the host-RAM tier, resumes into prefill/decode),
    ``timeout`` (queue wait exceeded ``max_queue_delay_s``), ``shed``
    (displaced from a full bounded queue) and ``cancelled``.
    ``priority`` (higher = more important) and ``deadline`` define the
    scheduling class: admission is priority-then-EDF, preemption
    victims come from strictly lower classes only."""
    request_id: int
    prompt: np.ndarray                 # [prompt_len] padded
    seq_len: int
    max_new_tokens: int
    arrival_time: float
    pad_token_id: int = 0
    tokens: List[int] = field(default_factory=list)
    remaining: int = 0                 # decode-step budget left
    slot: Optional[int] = None
    submit_time: float = 0.0
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    state: str = "queued"
    priority: int = 0                  # higher admits/survives first
    deadline: Optional[float] = None   # absolute clock() time
    max_queue_delay_s: Optional[float] = None
    swap: Optional[_SwapRecord] = None
    preempt_count: int = 0
    spec_k: Optional[int] = None       # speculative mode: drafts/verify
    adapter: Optional[str] = None      # LoRA adapter name (None = base)
    adapter_slot: Optional[int] = None  # pinned arena slot while admitted
    tenant: str = "default"            # fair-share accounting bucket
    sampling: Optional[SamplingParams] = None  # None = plain greedy
    samp_base: Optional[np.ndarray] = None     # [2] u32 PRNG base key
    pf_pos: int = 0                    # next prompt position to compute
    matched: List[int] = field(default_factory=list)   # prefix-hit blocks
    host_pins: List[int] = field(default_factory=list)  # pinned tier keys
    rspan: List = field(default_factory=list)  # radix span at last probe
    rmatch_tokens: int = 0             # token-level match at last probe
    # goodput ledger: prompt positions in [gp_recompute_from,
    # gp_recompute_to) were matched token-level by the prefix cache at
    # admission but could NOT be mapped (partial tail past the last
    # full block, dropped host parcels, tier-evict holes) — their
    # prefill recompute is charged wasted{reason="recompute_cache"}
    gp_recompute_from: int = 0
    gp_recompute_to: int = 0
    n_emitted: int = 0                 # tokens at finish, before padding
    blocks: List[int] = field(default_factory=list)    # full block map
    digests: List[bytes] = field(default_factory=list)
    registered: int = 0                # blocks published so far
    chunk_ids: Optional[np.ndarray] = None  # prompt padded to chunk grid

    @property
    def output(self) -> np.ndarray:
        return np.asarray(self.tokens, np.int32)

    @property
    def latency(self) -> Optional[float]:
        if self.finish_time is None:
            return None
        return self.finish_time - self.arrival_time

    @property
    def ttft(self) -> Optional[float]:
        """Time to first token (arrival -> last prefill chunk)."""
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time


class TokenStream:
    """Incremental token stream of one streaming request
    (``submit(stream=True)`` returns one; so does the router's).

    A stream handle never drives the device: ``read()`` drains the
    tokens that are already host truth, everything the engine has
    harvested so far, and advances a cursor.  On a dispatch-ahead engine
    the tokens of a deferred dispatch become host truth at the harvest
    point, so the stream's flush boundaries ARE the pipeline's harvest
    points: streaming adds no host wait and no entry in
    ``ASYNC_SYNC_REASONS``, and the concatenation of every flush is
    token for token the non-streamed ``Request.output`` (terminal pad
    tail included).

    ``owner`` is whatever schedules the request (a ``ServingEngine`` or
    a ``Router``): iterating the stream calls ``owner.step()`` between
    flushes, so ``for chunk in stream: ...`` is a working chat loop.
    ``read()``/``finished`` are the primitives for callers that drive
    the scheduler themselves."""

    def __init__(self, owner, target):
        self._owner = owner
        self._target = target
        self._pos = 0
        # a safety cap for __iter__: a healthy drain finishes a request
        # in far fewer steps; a wedged pool raises instead of spinning
        self._max_iter_steps = 100_000

    @property
    def request(self):
        """The underlying request handle (engine ``Request``, or the
        router's ``RoutedRequest``)."""
        return self._target

    @property
    def finished(self) -> bool:
        return self._target.state in TERMINAL_STATES

    @property
    def n_read(self) -> int:
        """Tokens delivered through this handle so far."""
        return self._pos

    def read(self) -> np.ndarray:
        """Every token that became host truth since the last read
        (possibly empty); never blocks, never forces a pending harvest.
        The cursor never moves backward: during a failover recompute the
        underlying token list restarts from the prompt, the replayed
        prefix is bit-identical to what was already flushed (the
        position-keyed PRNG), and the stream splices at the last flushed
        token, so nothing is emitted twice."""
        toks = self._target.tokens
        new = toks[self._pos:]
        self._pos = max(self._pos, len(toks))
        return np.asarray(new, np.int32)

    def __iter__(self):
        steps = 0
        while True:
            chunk = self.read()
            if chunk.size:
                yield chunk
            if self.finished:
                tail = self.read()   # the terminal pad landed after the
                if tail.size:        # last scheduler flush
                    yield tail
                return
            self._owner.step()
            steps += 1
            if steps > self._max_iter_steps:
                raise RuntimeError(
                    f"TokenStream iteration exceeded "
                    f"{self._max_iter_steps} scheduler steps without "
                    f"the request reaching a terminal state")


class ServingEngine:
    """Continuous-batching serving session over a paged KV block pool.

    ``submit()`` enqueues requests (optionally with a future
    ``arrival_time`` for trace replay); ``cancel()`` drops one from any
    live phase; ``step()`` runs one scheduler iteration (timeouts, admit
    and resume, at most one prefill chunk, one verify forward over the
    spec-mode slots, one decode block); ``run()`` drains everything and
    returns the terminal requests.

    The engine runs on ``device`` (default: the CUDA card; ``"cpu"``
    for tests) and moves the model there, casting its float parameters
    to ``compute_dtype`` in place once — the JAX engine's once-per-call
    hoisted cast (``_cast_params``).  The KV arenas live on the device
    and are updated in place by every program; only the host-RAM tier's
    parcels (preemption swap-outs and radix-cache demotions) are host
    copies.

    ``kv_cache_dtype="int8"`` stores the cache as int8 codes plus f32
    per-entry per-kv-head scales (quantize on append, dequantize in the
    attention read).  ``weight_dtype="int8"|"int4"`` quantizes the hot
    projections once, from the weights as stored (before the cast), into
    code planes and per-output-channel scales that every program reads
    through the quantized-matmul kernel; the float model stays on the
    device beside them.

    ``submit(spec_decode=K)`` puts a request in greedy speculative mode:
    each iteration the engine-level ``drafter`` (an ``NGramDrafter`` unless
    one is given; a ``ModelDrafter`` runs a draft model's ``generate()``)
    proposes up to K tokens per spec slot, one verify forward scores them
    at the engine-lifetime width ``max(spec_decode) + 1``, and the
    accepted prefix plus a correction token is emitted.  The tokens are
    the sequential greedy stream's.

    Overload: with ``enable_preemption`` a request the pool cannot serve
    swaps strictly-worse running requests out to host RAM (exact
    at-rest bytes; they resume bit-identically); ``max_queue`` bounds
    the queue (shedding the worst queued request of a strictly lower
    class, else raising ``AdmissionError``); ``submit(
    max_queue_delay_s=)`` times a request out of the queue.  In
    ``prefix_cache_mode="radix"`` cached prompt blocks the pool reclaims
    are demoted to the host tier (``host_cache_blocks`` of them at most)
    and promoted back on a later hit.

    Dispatch-ahead (``async_dispatch=True``, the default): ``step()``
    plans on host truth that may be one dispatch stale and enqueues its
    decode dispatch before it harvests the previous one, so the host's
    scheduling runs while the card decodes.  A harvest is deferred only
    when the next iteration's scheduling cannot depend on it; everywhere
    host truth is required the iteration syncs and charges one reason of
    ``ASYNC_SYNC_REASONS``, so at ``async_depth=1`` tokens and scheduling
    equal ``async_dispatch=False``'s.  ``async_depth=S >= 2`` reads EOS
    from the in-trace finish bitmap one harvest late and dispatches
    provably eventless windows of S iterations as one fused program.
    Demote gathers of the radix cache ride the same pipeline and reach
    the host at the next harvest point.
    """

    def __init__(self, model, *, num_slots, prompt_len,
                 max_cache_len=None, steps_per_call=1,
                 block_len=16, num_blocks=None, chunk_len=None,
                 enable_prefix_cache=True, prefix_cache_mode=None,
                 host_cache_blocks=None, drafter=None,
                 eos_token_id=None, pad_token_id=0,
                 do_sample=False, temperature=1.0, top_k=0, top_p=1.0,
                 compute_dtype="bfloat16", cache_dtype=None,
                 kv_cache_dtype=None, weight_dtype=None,
                 seed=0, static_batching=False, clock=time.perf_counter,
                 registry=None, max_queue=None, enable_preemption=True,
                 fault_injector=None, flight_recorder=None,
                 async_dispatch=True, async_depth=1,
                 adapter_store=None, tenant_weights=None, mesh=None,
                 role="both", device: DeviceLike = None):
        if mesh is not None:
            _not_ported("mesh= (tensor-parallel serving)",
                        "#10 Sharded serving")
        # disaggregation role: pure policy over the migration mechanism;
        # "both" keeps every trace byte-identical to a role-less engine
        self.role = str(role)
        if self.role not in ENGINE_ROLES:
            raise ValueError(
                f"role must be one of {ENGINE_ROLES}, got {role!r}")
        # the router reads this: no shard group (a single-device engine)
        self.shard_group = None
        self._fault = fault_injector
        # async_dispatch=False is the lockstep arm; async_depth=1 keeps
        # its scheduling bit for bit, S >= 2 opts into the finish bitmap
        # and the fused windows
        self.async_dispatch = bool(async_dispatch)
        self.async_depth = int(async_depth)
        if self.async_depth < 1:
            raise ValueError(
                f"async_depth must be >= 1, got {async_depth}")
        if self.async_depth > 1 and not self.async_dispatch:
            raise ValueError(
                f"async_depth={self.async_depth} needs "
                f"async_dispatch=True — the lockstep kill-switch arm "
                f"has no pipeline to deepen")
        self.max_queue = None if max_queue is None else int(max_queue)
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(
                f"max_queue must be >= 1 (or None = unbounded), got "
                f"{max_queue}")
        self.enable_preemption = bool(enable_preemption)
        # an explicit prefix_cache_mode wins over the legacy bool, as in
        # the JAX engine
        if prefix_cache_mode is None:
            mode = "radix" if enable_prefix_cache else "none"
        else:
            mode = str(prefix_cache_mode)
            if mode not in ("radix", "digest", "none"):
                raise ValueError(
                    f"prefix_cache_mode must be 'radix', 'digest' or "
                    f"'none', got {prefix_cache_mode!r}")
        self.prefix_cache_mode = mode
        self.enable_prefix_cache = mode != "none"
        self.device = resolve_device(device)
        self.num_slots = int(num_slots)
        self.prompt_len = int(prompt_len)
        self.max_cache_len = int(max_cache_len or (prompt_len + 256))
        self.steps_per_call = int(steps_per_call)
        self.block_len = int(block_len)
        self.static_batching = bool(static_batching)
        if self.num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if self.steps_per_call < 1:
            raise ValueError(
                f"steps_per_call must be >= 1, got {steps_per_call}")
        if self.block_len < 1:
            raise ValueError(f"block_len must be >= 1, got {block_len}")
        if self.max_cache_len < self.prompt_len + 1:
            raise ValueError(
                f"max_cache_len ({self.max_cache_len}) must be >= "
                f"prompt_len + 1 ({self.prompt_len + 1})")
        self.max_blocks = -(-self.max_cache_len // self.block_len)
        self.num_blocks = (int(num_blocks) if num_blocks is not None
                           else self.num_slots * self.max_blocks)
        if self.num_blocks < 1:
            raise ValueError(
                f"num_blocks must be >= 1, got {self.num_blocks}")
        self.chunk_len = (int(chunk_len) if chunk_len is not None
                          else self.prompt_len)
        if self.chunk_len < 1:
            raise ValueError(f"chunk_len must be >= 1, got {chunk_len}")
        self.cfg = GenerationConfig(
            eos_token_id=eos_token_id, pad_token_id=int(pad_token_id),
            compute_dtype=str(compute_dtype),
            cache_dtype=None if cache_dtype is None else str(cache_dtype))
        # the engine-level sampling knobs are the DEFAULT per-request
        # params (submit(sampling=) overrides); default-sampled requests
        # draw from fold_in(PRNGKey(seed), request_id)
        self._default_sampling = (SamplingParams(
            temperature=float(temperature), top_k=int(top_k),
            top_p=float(top_p)).validate() if do_sample else None)
        self._seed = int(seed)
        cdt = to_dtype(self.cfg.compute_dtype)
        if not cdt.is_floating_point:
            raise ValueError(f"compute_dtype must be a float dtype, got "
                             f"{compute_dtype!r}")
        # the KV dtype is validated before any weight is touched
        n_layers, hkv, d = model.kv_cache_spec()
        kvdt = (kv_cache_dtype if kv_cache_dtype is not None
                else (self.cfg.cache_dtype or self.cfg.compute_dtype))
        kv_dt = self._kv_dtype(kvdt)
        if kv_dt != torch.int8 and kv_dt != cdt:
            # the JAX gate sends a mixed (q, cache) dtype pair to its XLA
            # path; the port has no such path on the card
            raise NotImplementedError(
                f"a KV cache dtype ({dtype_name(kv_dt)}) other than "
                f"compute_dtype ({dtype_name(cdt)}) is not ported yet: the "
                f"paged decode kernel takes one dtype (ROADMAP.md, Queue 1: "
                f"#11 LLMPredictor and the dense generate programs)")
        # multi-tenant batched LoRA serving (inference/lora.py): the paged
        # adapter store is engine-external (several engines may share
        # one); submit(adapter=) names a registered variant, admission
        # pins its arena slot, every dispatch with >= 1 adapter row runs
        # the gathered-product variant.  The arenas must be at the
        # compute dtype (the products contract against activations) and
        # on the engine's device; checked before any weight is touched
        if adapter_store is not None:
            if adapter_store.dtype != cdt:
                raise ValueError(
                    f"adapter_store dtype {dtype_name(adapter_store.dtype)}"
                    f" != engine compute_dtype {dtype_name(cdt)} — the "
                    f"gathered LoRA einsums contract against activations "
                    f"of the compute dtype")
            if adapter_store.n_layers != n_layers:
                raise ValueError(
                    f"adapter_store holds {adapter_store.n_layers} "
                    f"layers but the model has {n_layers}")
            if adapter_store.device != self.device:
                raise ValueError(
                    f"adapter_store arenas live on "
                    f"{adapter_store.device}, the engine on {self.device}")
        self._adapters = adapter_store
        # fair-share admission (deficit-weighted round-robin): per-tenant
        # token-service accounting; a weight scales a tenant's share (2.0
        # = entitled to twice a weight-1 tenant's service).  On a single
        # tenant the fair term is a constant and scheduling is the plain
        # priority/EDF/FIFO order
        self._tenant_weights = {}
        for t, w in dict(tenant_weights or {}).items():
            w = float(w)
            if w <= 0:
                raise ValueError(
                    f"tenant_weights[{t!r}] must be > 0, got {w}")
            self._tenant_weights[str(t)] = w
        self._tenant_served: dict = {}     # tenant -> tokens charged
        self._lora_dispatches = 0          # gathered-product dispatches
        # the host tier's capacity is validated before any weight is
        # touched too
        cache_cap = (int(host_cache_blocks) if host_cache_blocks is not None
                     else 4 * self.num_blocks)
        if cache_cap < 0:
            raise ValueError(
                f"host_cache_blocks must be >= 0, got {host_cache_blocks}")
        # weight_dtype: the plan quantizes the weights AS STORED, before
        # the cast to compute_dtype, as the JAX engine does
        wq_dtype = normalize_weight_dtype(weight_dtype)
        self._wq = (build_weight_quant_plan(model, wq_dtype).to(self.device)
                    if wq_dtype is not None else None)
        self._wq_ctx = self._wq.context() if self._wq is not None else None
        model.to(device=self.device, dtype=cdt)
        model.eval()
        self._model = model
        self.weight_dtype = wq_dtype or dtype_name(cdt)
        self._weight_sweep_bytes = self._weight_bytes(model, cdt)

        self.kv_cache_dtype = dtype_name(kv_dt)
        self._arenas: List[torch.Tensor] = []
        for entry in init_paged_kv_arena(
                n_layers, self.num_blocks, self.block_len, hkv, d, kv_dt,
                self.device):
            self._arenas += list(entry)
        # per-row KV bytes across all layers: codes plus the two f32
        # scale planes for int8
        row_bytes = 2 * hkv * d * kv_dt.itemsize
        if kv_dt == torch.int8:
            row_bytes += 2 * hkv * 4
        self._kv_row_bytes = row_bytes * n_layers
        self._digest_salt = ("ptpu-paged-kv/"
                             + self.kv_cache_dtype).encode()
        self._host_cache_cap = cache_cap    # kept for crash_reset()
        self._fresh_memory()
        self._swap_out = build_swap_out_gather()
        self._swap_in = build_swap_in_scatter(len(self._arenas))
        self._vocab = int(model.config.vocab_size)
        self._queue: deque = deque()
        self._prefilling: deque = deque()
        self._swapped: List[Request] = []   # preempted, host-RAM KV
        # chunk-final handoff staging (prefill-role engines only):
        # requests whose KV parcel waits in the host tier for the
        # router's take_handoffs()
        self._handoff_ready: List[Request] = []
        self._finished: List[Request] = []
        self._clock = clock
        self._next_id = 0
        self._peak_queue = 0
        self._peak_blocks = 0
        # host-side per-reason wasted-token mirror (the goodput counters
        # carry a tenant label; this keeps the closed per-reason
        # breakdown exact per engine)
        self._wasted_reason = {r: 0 for r in GOODPUT_REASONS}
        # scheduler accounting lives in the metrics registry (stats()
        # reads per-engine counter deltas back out of it);
        # peak_queue/peak_blocks mirror the gauges' high-water marks as
        # plain ints so stats() stays exact if the registry is disabled
        self._m = _ServingInstruments(
            registry if registry is not None else obs_metrics.get_registry())
        self._m.slots_total.set(self.num_slots)
        self._m.kv_quant_dtype.set(1, dtype=self.kv_cache_dtype)
        self._m.weights_quant_dtype.set(1, dtype=self.weight_dtype)
        self._m.swap_host_blocks.set(0, reason="preempt")
        self._m.swap_host_blocks.set(0, reason="cache")
        self._m.slot_occupancy.set(0)
        self._m.blocks_free.set(self.num_blocks)
        self._m.blocks_in_use.set(0)
        self._m.shard_groups.set(0)
        self._m.shard_width.set(1)
        self._m.role.set(1, role=self.role)
        self._m.async_depth.set(0)
        # per-request flight recorder: every lifecycle transition emits
        # a structured event.  The default is a DISABLED instance so the
        # emit sites stay uniform (one bool test per call) and
        # ``engine.flight_recorder.enable()`` can be flipped live;
        # bind_clock puts event wall times on the engine's clock unless
        # the recorder was constructed with a clock of its own
        self._fr = (flight_recorder if flight_recorder is not None
                    else FlightRecorder(enabled=False))
        self._fr.bind_clock(clock)
        # scheduler iteration index: stamped into every flight-recorder
        # event and incremented at step() start; submit()/cancel()
        # events between steps carry the last index
        self._step_idx = 0
        # host wall of the decode and verify dispatches (port-only
        # stats keys)
        self._decode_seconds = 0.0
        self._verify_seconds = 0.0
        # the step's wall split (serving.step.* histograms, and their
        # sums kept as engine totals so stats() has them with the
        # registry disabled too): dispatch sites, waits on a PREVIOUS
        # iteration's outputs (overlap), injected fault stalls and the
        # host remainder
        self._disp_s = 0.0
        self._overlap_s = 0.0
        self._stall_s = 0.0
        self._in_step = False
        self._time = dict(dispatch=0.0, overlap=0.0, host=0.0)
        # dispatch-ahead pipeline: the pending decode dispatches (at most
        # async_depth), demote parcels awaiting their rows, and finishes
        # a flush outside a step discovered (handed to the next step)
        self._pend_q: deque = deque()
        self._lazy_parcels: List[int] = []
        self._flush_finishes: List[Request] = []
        # step-rate estimate for the arrival-aware fused window: only
        # from explicit step(now=) clocks
        self._last_now = None
        self._step_dt = 0.0
        # decode-block programs keyed (total scanned steps, sampling flag
        # bucket, adapter variant), the JAX engine's _block_fn keys: CUDA
        # graphs on the card, the eager block on the CPU; and the pinned
        # ring their outputs land in
        self._blocks = {}
        self._graph_capture_s = 0.0
        self._ring: List[dict] = []
        self._ring_next = 0
        self._staging = _HostStaging(self.device)
        # speculative decoding: per-request mode (submit(spec_decode=K));
        # the drafter is engine-level and installed lazily (an
        # NGramDrafter) the first time a spec request is accepted
        self._drafter = drafter
        self._spec_k_max = 0           # engine-lifetime max spec_decode
        self._spec_fallback = set()    # this iteration's spec slots that
        #                                drafted nothing and ride the block
        self._verify_fns = {}          # (width, flags, lora) -> verifier

    def _fresh_memory(self):
        """A new, empty memory system: block pool, host tier, radix tree,
        slot tables and carries, wired together (construction and
        ``crash_reset``).  The arenas are not touched.  ONE host-RAM
        block store serves both uses: preemption swap-outs (reason
        "preempt", kept until resume) and radix-cache demotions (reason
        "cache", LRU-evicted beyond ``host_cache_blocks``)."""
        self._pool = BlockPool(self.num_blocks, self.block_len)
        self._host_tier = HostTier(cache_capacity_blocks=self._host_cache_cap)
        self._radix: Optional[RadixPrefixCache] = None
        # the pool and the tier call back into the engine and the tree
        # through weak references: a dropped engine frees its device
        # arenas at once, not at the next cyclic garbage collection
        me = weakref.ref(self)
        if self.prefix_cache_mode == "radix":
            self._radix = RadixPrefixCache(self.block_len, self._pool,
                                           self._host_tier)
            self._pool.reclaim_cb = lambda blocks: me()._demote_blocks(blocks)
            drop_host = weakref.WeakMethod(self._radix.drop_host)
            self._host_tier.evict_cb = lambda key: drop_host()(key)
            self._pool.audit_hooks.append(
                lambda: me()._radix.audit(me()._pool))
        self._pool.audit_hooks.append(lambda: me()._audit_host_tier())
        self._tables = np.full((self.num_slots, self.max_blocks),
                               self._pool.trash, np.int32)
        self._tok = np.zeros((self.num_slots,), np.int32)
        self._lens = np.zeros((self.num_slots,), np.int32)
        self._done = np.ones((self.num_slots,), bool)
        self._slots: List[Optional[Request]] = [None] * self.num_slots

    @staticmethod
    def _kv_dtype(kvdt) -> torch.dtype:
        """The KV arena dtype: any float dtype, or int8 for the
        quantized cache; everything else raises, int4 with a pointer at
        ``weight_dtype``."""
        if str(kvdt) == "int4":
            raise ValueError(
                "kv_cache_dtype must be a float dtype or 'int8' (the "
                "quantized KV cache), got 'int4' — 'int4' is a WEIGHT "
                "dtype: pass weight_dtype='int4' instead (the KV cache has "
                "no int4 mode)")
        try:
            kv_dt = to_dtype(kvdt)
        except ValueError:
            raise ValueError(f"unknown kv_cache_dtype {kvdt!r}") from None
        if kv_dt != torch.int8 and not kv_dt.is_floating_point:
            raise ValueError(
                f"kv_cache_dtype must be a float dtype or 'int8' (the "
                f"quantized KV cache), got {kvdt!r}")
        return kv_dt

    def _weight_bytes(self, model, cdt) -> int:
        """Modeled bytes ONE forward streams for the whole weight set:
        float parameters at the compute dtype, other parameters and
        buffers at their own width, quantized projections at their
        code+scale width (the JAX engine's ``_weight_sweep_bytes``)."""
        skip = self._wq.param_positions if self._wq is not None \
            else frozenset()
        wbytes = 0
        for i, p in enumerate(model.parameters()):
            if i in skip:
                continue
            item = cdt.itemsize if p.is_floating_point() \
                else p.element_size()
            wbytes += p.numel() * item
        wbytes += sum(b.numel() * b.element_size() for b in model.buffers())
        if self._wq is not None:
            wbytes += self._wq.bytes_swept()
        return wbytes

    # -- host <-> device --
    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """A host plane on the engine's device.  On the card it is staged
        in pinned memory and copied without blocking the host; the
        caching host allocator keeps the staging buffer until the copy
        has run, so it is never rewritten early."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cpu":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _stage_out(self, tensors):
        """Enqueue device -> host copies of ``tensors`` into fresh pinned
        buffers behind one event, all at once (a lazy demotion's copy
        rides the stream ahead of later work): ``(host tensors, event)``.
        On the CPU the tensors are already host tensors and the event is
        None."""
        if self.device.type == "cpu":
            return list(tensors), None
        host = []
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            host.append(h)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    def _fetch(self, tensors) -> List[np.ndarray]:
        """Device tensors to host numpy arrays that own their bytes,
        through the pinned staging buffers (the wait on their events is
        the one sync an intended host read makes)."""
        return self._staging.to_host(tensors)

    def _block_program(self, n: int, flags=NO_FLAGS, lora_on: bool = False):
        """The decode-block program of ``n`` total scanned steps under the
        sampling flag bucket ``flags``, with the adapter planes when
        ``lora_on``, built on first use and keyed ``(n, flags, lora_on)``
        as the JAX engine keys ``_block_fn``: ``program(tok, lens, done,
        budget, tables, samp=None, ids=None) -> (toks, tok', lens',
        done', budget')``, ``ids`` the per-row adapter slots of the
        adapter variant.  On the card a ``DecodeBlockGraph`` captured
        over this engine's arenas (and the store's), the capture's seconds
        going to ``decode_graphs``; on the CPU the eager block."""
        flags = tuple(bool(f) for f in flags)
        key = (n, flags, bool(lora_on))
        prog = self._blocks.get(key)
        if prog is not None:
            return prog
        # the program holds what it runs, never the engine: a dropped
        # engine frees its arenas and graph pools at once
        model, cfg, arenas, wq = (self._model, self.cfg, self._arenas,
                                  self._wq_ctx)
        lora = self._adapters.arena_planes() if lora_on else None
        if self.device.type == "cuda":
            t0 = time.perf_counter()
            prog = DecodeBlockGraph(model, cfg, n, self.num_slots,
                                    self.max_blocks, arenas, wq=wq,
                                    flags=flags, lora=lora)
            self._graph_capture_s += time.perf_counter() - t0
        else:
            def prog(tok, lens, done, budget, tables, samp=None, ids=None):
                planes = None if ids is None else dict(lora, ids=ids)
                return paged_decode_block(model, cfg, n, tok, lens, done,
                                          budget, tables, arenas, wq=wq,
                                          samp=samp, flags=flags,
                                          lora=planes)[:5]
        self._blocks[key] = prog
        return prog

    def _samp_tensors(self, planes: dict, dst: Optional[dict] = None):
        """A dispatch's host sampling planes (``_build_samp``) as device
        tensors: the ``[B]`` planes through ``_dev``, the ``[B, V]``
        presence and bias planes through the pinned staging, into
        ``dst[name]`` (a graph's static plane) when given, else into a
        fresh device tensor."""
        out = {}
        for k, a in planes.items():
            if k not in ("presence", "bias") or self.device.type == "cpu":
                out[k] = self._dev(a)
                continue
            t = torch.from_numpy(np.ascontiguousarray(a))
            d = dst[k] if dst is not None else torch.empty(
                t.shape, dtype=t.dtype, device=self.device)
            self._staging.to_device(t, d)
            out[k] = d
        return out

    def _stage_block(self, out):
        """Enqueue the host copies of one decode dispatch's outputs into
        a slot of the pinned ring (``async_depth + 1`` slots: at most
        ``async_depth`` dispatches are pending when the next one lands),
        right behind the dispatch on the same stream.  Returns
        ``(host tensors, event, slot)``; on the CPU the outputs
        themselves."""
        if self.device.type == "cpu":
            return tuple(out), None, None
        if not self._ring:
            b, nmax = self.num_slots, self.steps_per_call * self.async_depth
            for _ in range(self.async_depth + 1):
                self._ring.append(dict(
                    toks=torch.empty(b * nmax, dtype=torch.int32,
                                     pin_memory=True),
                    carries=[torch.empty(b, dtype=t.dtype, pin_memory=True)
                             for t in out[1:]],
                    event=torch.cuda.Event(), busy=False))
        slot = self._ring[self._ring_next]
        if slot["busy"]:
            raise RuntimeError(
                "dispatch-ahead: the pinned harvest ring is full — a "
                "dispatch landed while async_depth + 1 were unharvested")
        self._ring_next = (self._ring_next + 1) % len(self._ring)
        toks = out[0]
        host_toks = slot["toks"][:toks.numel()].view(toks.shape)
        host_toks.copy_(toks, non_blocking=True)
        for h, t in zip(slot["carries"], out[1:]):
            h.copy_(t, non_blocking=True)
        slot["event"].record()
        slot["busy"] = True
        return (host_toks, *slot["carries"]), slot["event"], slot

    def _block_host(self, p: _PendingBlock):
        """A pending dispatch's outputs as owned host arrays ``(toks,
        tok, lens, done)`` (the wait on its event is the harvest's only
        sync); frees its ring slot."""
        if p.event is not None:
            p.event.synchronize()
        arrays = [np.array(t.numpy(), copy=True) for t in p.host[:4]]
        if p.slot is not None:
            p.slot["busy"] = False
            p.slot = None
        return arrays

    # -- block accounting --
    def _blocks_needed(self, n: int, m: int) -> int:
        """Blocks a request writes: prompt + generated K/V is n + m - 1
        slots (the last sampled token is emitted, never fed back)."""
        return -(-(n + m - 1) // self.block_len)

    def _update_block_gauges(self):
        free = self._pool.available()
        in_use = self._pool.in_use()
        self._m.blocks_free.set(free)
        self._m.blocks_in_use.set(in_use)
        self._peak_blocks = max(self._peak_blocks, in_use)

    def _update_host_gauge(self):
        self._m.swap_host_blocks.set(
            self._host_tier.blocks("preempt"), reason="preempt")
        self._m.swap_host_blocks.set(
            self._host_tier.blocks("cache"), reason="cache")

    def _set_occupancy(self):
        self._m.slot_occupancy.set(sum(r is not None for r in self._slots))

    def _count_kv_sweep(self, last_indices):
        """Model one dispatch's KV read traffic into ``kv_bytes_swept``:
        one entry per (row, scanned step) giving that sweep's last valid
        index, rounded up to whole blocks (the paged kernels' ``length //
        L + 1`` block walk, clamped to the table span) and charged the
        per-row cost of every layer (codes plus scale planes for int8).
        Modeled, not measured, and participating rows only: vacant and
        frozen rows in the same dispatch are not charged."""
        rows = sum(min(int(ix) // self.block_len + 1, self.max_blocks)
                   * self.block_len for ix in last_indices)
        self._m.kv_bytes_swept.inc(rows * self._kv_row_bytes)

    def _count_weight_sweep(self, forwards: int):
        """Modeled weight-streaming traffic: every dispatched forward
        (one decode scan step, one prefill chunk, one verify pass)
        streams the whole weight set once (``_weight_sweep_bytes``)."""
        self._m.weights_bytes_swept.inc(
            int(forwards) * self._weight_sweep_bytes)

    # -- goodput ledger --
    def _ledger(self, useful: int, tenant: str = "default",
                **wasted: int):
        """Account one dispatch's token-positions into the goodput
        ledger.  Conservation (useful + wasted == dispatched) holds by
        construction: the dispatched counter is incremented by exactly
        the sum of the classified parts.  Positions are counted over
        PARTICIPATING rows only (the ``_count_kv_sweep`` convention:
        vacant and frozen rows are excluded)."""
        total = useful
        for reason, n in wasted.items():
            if reason not in GOODPUT_REASONS:
                raise ValueError(
                    f"unknown goodput waste reason {reason!r} — known: "
                    f"{GOODPUT_REASONS}")
            if n < 0:
                raise ValueError(
                    f"goodput ledger: negative {reason} count {n} — a "
                    f"dispatch was mis-split")
            total += n
        if useful < 0:
            raise ValueError(
                f"goodput ledger: negative useful count {useful}")
        if total == 0:
            return
        self._m.goodput_dispatched.inc(total, tenant=tenant)
        if useful:
            self._m.goodput_useful.inc(useful, tenant=tenant)
        for reason, n in wasted.items():
            if n:
                self._m.goodput_wasted.inc(n, reason=reason,
                                           tenant=tenant)
                self._wasted_reason[reason] += n

    @staticmethod
    def _slo_class(req: Request) -> str:
        """The SLO-attainment class label: the priority class."""
        return f"p{req.priority}"

    def _slo_account(self, req: Request):
        """Score a terminal request against its SLO, by class.  Only
        SLO-carrying requests (a deadline or a queue-delay bound)
        count; a late finish is the 'missed' outcome a deadline feeds;
        cancelled requests are a user action, not an SLO outcome."""
        if req.deadline is None and req.max_queue_delay_s is None:
            return
        cls = self._slo_class(req)
        if req.state == "finished" and (
                req.deadline is None or req.finish_time <= req.deadline):
            self._m.slo_attained.inc(**{"class": cls,
                                        "tenant": req.tenant})
        elif req.state in ("finished", "timeout", "shed"):
            self._m.slo_missed.inc(**{"class": cls,
                                      "tenant": req.tenant})

    def _release_blocks(self, req: Request):
        """Unpin every block the request holds, drop its adapter pin and
        trash its table row.  Idempotent: the block list and the adapter
        slot are cleared before returning."""
        for b in req.blocks:
            self._pool.unpin(b)
        req.blocks = []
        req.matched = []
        if req.adapter_slot is not None:
            # the adapter pin has exactly the blocks' lifetime (admission
            # to retirement or preemption)
            self._adapters.release(req.adapter)
            req.adapter_slot = None
        if req.slot is not None:
            self._tables[req.slot] = self._pool.trash
        self._update_block_gauges()

    def _alloc(self, n: int) -> Optional[List[int]]:
        """``BlockPool.alloc`` behind the fault-injection hook: an armed
        allocation failure makes the pool look dry to exactly this call
        — admission back-off, the valve and preemption all run their
        real paths."""
        if self._fault is not None and self._fault.take_alloc_failure():
            return None
        return self._pool.alloc(n)

    # -- host tier (shared by preemption swap and radix demotion) --
    def _gather_rows(self, ids_row: np.ndarray, keep: int,
                     materialize: bool = True):
        """The first ``keep`` rows of ``ids_row`` (table-width, trash-
        padded) out of every arena at their exact at-rest bytes:
        ``(stacks, dtypes)``, one stack ``[keep, ...]`` and one dtype
        name per flat arena (a bf16 stack holds the ``uint16`` view of
        its bits).  The gather and its copy into pinned host memory are
        enqueued on the engine's stream.  ``materialize=True`` waits for
        them and returns numpy stacks (preemption: a swap record's bytes
        are correctness-bearing); ``materialize=False`` returns a
        ``_LazyStacks`` that resolves at the next harvest point (the
        dispatch-ahead demotion)."""
        t0 = self._clock()
        ids = self._dev(ids_row.astype(np.int64))
        dev = [row_bits(r[:keep])
               for r in self._swap_out(ids, *self._arenas)]
        stacks = (self._fetch(dev) if materialize
                  else _LazyStacks(*self._stage_out(dev)))
        self._disp_s += self._clock() - t0
        return stacks, tuple(dtype_name(a.dtype) for a in self._arenas)

    def _scatter_rows(self, ids_row: np.ndarray, stacks: List[np.ndarray],
                      dtypes):
        """Write per-arena row ``stacks`` (k <= table-width rows each,
        bits decoding to ``dtypes``) into the arena rows named by
        ``ids_row`` through the swap-in scatter, shared by preemption
        resume and radix promotion.  Stacks are zero-padded to table
        width on the device; ``ids_row`` routes the pad rows at the
        trash row.  A stack whose dtype or row shape is not its arena's
        raises."""
        if len(stacks) != len(self._arenas):
            raise ValueError(f"host parcel holds {len(stacks)} row stacks "
                             f"for {len(self._arenas)} arenas")
        if dtypes is None:
            dtypes = [str(s.dtype) for s in stacks]
        t0 = self._clock()
        padded = []
        for s, dt, a in zip(stacks, dtypes, self._arenas):
            t = parcel_tensor(s, dt, a)
            pr = torch.zeros((self.max_blocks,) + tuple(a.shape[1:]),
                             dtype=a.dtype, device=a.device)
            self._staging.to_device(t, pr[:t.shape[0]])
            padded.append(pr)
        self._swap_in(self._dev(ids_row.astype(np.int64)), *padded,
                      *self._arenas)
        self._disp_s += self._clock() - t0

    def _demote_blocks(self, blocks: List[int]):
        """``BlockPool.reclaim_cb`` (radix mode): gather the reclaimed
        cached blocks' exact at-rest bytes out of every arena and demote
        them to the host tier; the radix tree relabels the positions
        host-resident so a later hit swaps the bytes back in rather than
        recomputing.  One gather per table width of blocks.  When the
        tier cannot take parcels the positions become holes and no
        gather runs."""
        if not self._host_tier.would_accept(1):
            for b in blocks:
                self._radix.drop_hbm(b)
            return
        demoted = 0
        w = self.max_blocks
        with _span("serving.cache_swap_out", blocks=len(blocks)):
            for i in range(0, len(blocks), w):
                chunk = blocks[i:i + w]
                ids = np.full((w,), self._pool.trash, np.int32)
                ids[:len(chunk)] = chunk
                if self.async_dispatch:
                    # overlapped swap-out: the gather is ENQUEUED now (a
                    # copy out of the arenas, ordered before any later
                    # write to the reclaimed blocks on the same stream)
                    # and each parcel gets a lazy row view, resolved at
                    # the next harvest point (_reconcile_host_tier)
                    lazy, dtypes = self._gather_rows(ids, len(chunk),
                                                     materialize=False)
                    for j, b in enumerate(chunk):
                        key = self._radix.demote(
                            b, lambda ls=lazy, j=j: ls.block_rows(j),
                            dtypes)
                        if key is not None:
                            demoted += 1
                            self._lazy_parcels.append(key)
                    continue
                stacks, dtypes = self._gather_rows(ids, len(chunk))
                for j, b in enumerate(chunk):
                    rows = [np.ascontiguousarray(s[j:j + 1])
                            for s in stacks]
                    if self._radix.demote(b, rows, dtypes) is not None:
                        demoted += 1
        if demoted:
            self._m.swap_out_blocks.inc(demoted, reason="cache")
            self._m.swap_out_bytes.inc(
                demoted * self.block_len * self._kv_row_bytes,
                reason="cache")
            # engine-scoped (the pool demotes on behalf of the cache,
            # not of one request): lane -1 in the chrome export
            self._fr.emit("swap_out", ENGINE_EVENT, self._step_idx,
                          blocks=demoted, reason="cache")
        self._update_host_gauge()

    def _reconcile_host_tier(self):
        """Materialize every demote parcel enqueued during plan, at a
        harvest point instead of inside admission: each live parcel ends
        up owning its contiguous per-block rows.  Dropped, evicted and
        promoted keys are skipped.  The wait charges to overlap."""
        if not self._lazy_parcels:
            return
        keys, self._lazy_parcels = self._lazy_parcels, []
        t0 = self._clock()
        for k in keys:
            e = self._host_tier.entry(k)
            if e is not None and not e.resolved:
                e.rows     # the property materializes on first access
        self._charge_overlap(self._clock() - t0)

    def _resolve_entries(self, entries):
        """Force still-lazy parcels a consumer (promotion, resume) needs
        now; the wait is on a previous iteration's gather, so it charges
        to overlap."""
        lazy = [e for e in entries if e is not None and not e.resolved]
        if not lazy:
            return
        t0 = self._clock()
        for e in lazy:
            e.rows
        self._charge_overlap(self._clock() - t0)

    def _audit_host_tier(self):
        """``BlockPool.check()`` hook: tier-internal invariants plus the
        preempt-key <-> swap-list bijection (cache keys are audited
        against the tree by ``RadixPrefixCache.audit``)."""
        errs = list(self._host_tier.audit())
        want = sorted(r.swap.host_key for r in self._swapped)
        got = sorted(self._host_tier.keys("preempt"))
        if want != got:
            errs.append(
                f"host tier preempt keys {got} != swap-list records "
                f"{want}")
        return errs

    # -- request intake --
    def submit(self, prompt_ids, seq_len=None, max_new_tokens=32,
               arrival_time=None, spec_decode=None, sampling=None,
               priority: int = 0, deadline_s: Optional[float] = None,
               max_queue_delay_s: Optional[float] = None,
               adapter: Optional[str] = None, tenant: Optional[str] = None,
               stream: bool = False):
        """Enqueue one request.  ``prompt_ids`` is a 1-D id array of at
        most ``prompt_len`` tokens (right-padded internally);
        ``arrival_time`` (in ``clock()`` units) lets a trace replay
        future arrivals.  ``priority`` (higher admits first, is preempted
        last) and ``deadline_s`` (seconds from arrival; EDF within a
        priority, never a kill) order admission; ``max_queue_delay_s``
        bounds the queue wait (a request still queued after it ends
        ``"timeout"``).  With prefix caching on, the prompt is probed
        against the cache here and the hits are PINNED so they cannot be
        reclaimed while the request waits.  With ``max_queue`` set, a
        full queue sheds after every validation: expired entries are
        swept first, then the worst queued request of a strictly lower
        class than this one is displaced (``"shed"``) or this submit
        raises ``AdmissionError`` and nothing is enqueued.

        ``sampling=SamplingParams(...)`` gives this request its own
        decode configuration (temperature, top-k, top-p, repetition
        penalty, seed, token-mask processor); the default is the engine's
        (``do_sample=True`` knobs, or greedy).  A sampled spec request
        runs speculative sampling; ``spec_decode`` with a mask processor
        raises.

        ``stream=True`` returns a :class:`TokenStream` over the request
        instead of the request itself (``handle.request`` recovers it):
        its flushes land at the engine's harvest points, token for token
        the non-streamed output.  A decode-role engine refuses every
        fresh submit with ``AdmissionError`` (only ``migrate_in``
        parcels land there)."""
        if self.role == "decode":
            raise AdmissionError(
                "decode-role engine does not accept fresh submits "
                "(prompts route to prefill-capable replicas; this "
                "replica only resumes migrated KV parcels)")
        ids = np.asarray(prompt_ids).reshape(-1).astype(np.int32)
        if ids.size < 1 or ids.size > self.prompt_len:
            raise ValueError(
                f"prompt must be 1..{self.prompt_len} tokens, got "
                f"{ids.size}")
        n = int(seq_len) if seq_len is not None else int(ids.size)
        if n < 1 or n > ids.size:
            raise ValueError(
                f"seq_len must be in [1, {ids.size}], got {n}")
        m = int(max_new_tokens)
        if m < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {m}")
        if sampling is not None:
            if not isinstance(sampling, SamplingParams):
                raise ValueError(
                    f"sampling must be a SamplingParams, got "
                    f"{type(sampling).__name__}")
            sampling.validate()
        sp = sampling if sampling is not None else self._default_sampling
        spec_k = None
        if spec_decode is not None:
            spec_k = int(spec_decode)
            if spec_k < 1:
                raise ValueError(
                    f"spec_decode must be >= 1 draft tokens, got "
                    f"{spec_decode}")
            if sp is not None and sp.mask_processor is not None:
                raise ValueError(
                    "spec_decode cannot compose with a token-mask "
                    "processor: a draft position's mask depends on "
                    "host-side state the drafter bypasses — submit "
                    "the request without spec_decode (sampling "
                    "without a mask composes fine)")
        if n + m - 1 > self.max_cache_len:
            raise ValueError(
                f"prompt ({n}) + max_new_tokens ({m}) - 1 = {n + m - 1} "
                f"tokens ({self._blocks_needed(n, m)} blocks of "
                f"{self.block_len}) exceeds max_cache_len "
                f"({self.max_cache_len} tokens = {self.max_blocks} "
                f"blocks per slot)")
        if self._blocks_needed(n, m) > self.num_blocks:
            raise ValueError(
                f"request needs {self._blocks_needed(n, m)} blocks of "
                f"{self.block_len} ({n + m - 1} tokens) but the pool "
                f"only has num_blocks={self.num_blocks} — it could "
                f"never be admitted")
        if adapter is not None:
            adapter = str(adapter)
            if self._adapters is None:
                raise ValueError(
                    f"submit(adapter={adapter!r}) needs an engine "
                    f"constructed with adapter_store= (no AdapterStore "
                    f"is attached)")
            if self._adapters.state(adapter) is None:
                raise ValueError(
                    f"adapter {adapter!r} is not registered in the "
                    f"adapter store — known: {self._adapters.names()}")
        prio = int(priority)
        if deadline_s is not None and float(deadline_s) <= 0:
            raise ValueError(
                f"deadline_s must be > 0 seconds from arrival, got "
                f"{deadline_s}")
        if max_queue_delay_s is not None and float(max_queue_delay_s) < 0:
            raise ValueError(
                f"max_queue_delay_s must be >= 0, got {max_queue_delay_s}")
        padded = np.full((self.prompt_len,), self.cfg.pad_token_id,
                         np.int32)
        padded[:ids.size] = ids
        now = self._clock()
        arrival = now if arrival_time is None else float(arrival_time)
        deadline = None if deadline_s is None \
            else arrival + float(deadline_s)
        req = Request(self._next_id, padded, n, m, arrival,
                      pad_token_id=self.cfg.pad_token_id)
        req.submit_time = now
        req.priority = prio
        req.deadline = deadline
        req.max_queue_delay_s = (None if max_queue_delay_s is None
                                 else float(max_queue_delay_s))
        req.spec_k = spec_k
        req.adapter = adapter
        req.tenant = "default" if tenant is None else str(tenant)
        # a waiting tenant exists in the service ledger at 0, so the
        # deficit gauges (and the round-robin's choice) see it at once
        self._tenant_served.setdefault(req.tenant, 0)
        req.sampling = sp
        if sp is not None and not sp.is_greedy:
            # an explicit seed draws from the user's stream; a seedless
            # sampled request folds its id into the engine seed, so
            # concurrent streams differ and a replayed trace reproduces
            req.samp_base = (base_key(sp.seed) if sp.seed is not None
                             else threefry.fold_in(threefry.as_key(
                                 threefry.prng_key(self._seed)),
                                 req.request_id).numpy().astype(np.uint32))
        # chunk grid: any slice [start, start + chunk_len) with
        # start < seq_len must be in range
        req.chunk_ids = np.full((self.prompt_len + self.chunk_len,),
                                self.cfg.pad_token_id, np.int32)
        req.chunk_ids[:self.prompt_len] = padded
        # past this point the prefix probe may hold pins: any failure
        # must unpin them and drop the request, or each failed submit
        # would leak refcounts until the pool wedges
        try:
            if self._radix is not None:
                self._probe_radix(req)
                if req.matched:
                    self._update_block_gauges()
            elif self.enable_prefix_cache:
                req.digests = _block_digests(padded, n, self.block_len,
                                             salt=self._digest_salt)
                # match at most (n-1)//block_len blocks: the block holding
                # the prompt's LAST token is always recomputed — sampling
                # the first output token needs its hidden state
                self._match_prefix(req)
                if req.matched:
                    self._update_block_gauges()
            if sp is not None and sp.mask_processor is not None:
                # the state machine's init and the width check, after the
                # probe: a raise rolls back through the unpin path below
                sp.mask_processor.begin(ids[:n])
                allowed0 = np.asarray(sp.mask_processor.allowed(), bool)
                if allowed0.size != self._vocab:
                    raise ValueError(
                        f"mask_processor.allowed() is {allowed0.size} "
                        f"wide but the model vocabulary is {self._vocab}")
                if not allowed0.any():
                    # an all-banned state would make the bias plane a
                    # uniform shift and the first token illegal; a dead
                    # end mid-stream finishes the request instead
                    raise ValueError(
                        "mask_processor allows no token in its start "
                        "state — the grammar has no legal first output")
            # the bounded queue LAST, after every validation: an invalid
            # submission never displaces an innocent queued request
            evict = None
            if self.max_queue is not None and \
                    len(self._queue) >= self.max_queue:
                self._sweep_timeouts(now, [])
            if self.max_queue is not None and \
                    len(self._queue) >= self.max_queue:
                worst = min(reversed(self._queue), key=self._shed_key)
                if self._shed_key(worst) < (prio, _neg_deadline(deadline)):
                    evict = worst
                else:
                    self._m.shed.inc(reason="rejected")
                    _span_instant("serving.request.reject",
                                  queue_depth=len(self._queue))
                    raise AdmissionError(
                        f"queue full ({len(self._queue)} >= max_queue="
                        f"{self.max_queue}) and no queued request is "
                        f"of strictly lower class than this arrival "
                        f"(priority={prio}, deadline_s={deadline_s})",
                        queue_depth=len(self._queue),
                        max_queue=self.max_queue)
            if spec_k is not None:
                # only after every validation and the bounded-queue
                # decision: a rejected submit must not widen the
                # engine-lifetime verify width or install the default
                # drafter
                if self._drafter is None:
                    self._drafter = NGramDrafter()
                self._spec_k_max = max(self._spec_k_max, spec_k)
            self._next_id += 1
            self._queue.append(req)
            _span_instant("serving.request.queued",
                          request=req.request_id, seq_len=n, max_new=m)
            self._fr.emit("submit", req.request_id, self._step_idx,
                          seq_len=n, max_new=m, priority=prio,
                          queue_depth=len(self._queue))
            if evict is not None:
                self._shed(evict, now)
            # peak AFTER a pending eviction: the one-element overshoot
            # between append and shed is submit-internal
            self._peak_queue = max(self._peak_queue, len(self._queue))
            # counters LAST: a failure above rolls the queue and pins
            # back, but a counter cannot be decremented
            self._m.requests_submitted.inc()
            self._m.queue_depth.set(len(self._queue))
        except BaseException:
            if self._queue and self._queue[-1] is req:
                self._queue.pop()
            for b in req.matched:
                self._pool.unpin(b)
            req.matched = []
            for k in req.host_pins:
                self._host_tier.unpin(k)
            req.host_pins = []
            self._update_block_gauges()
            self._m.queue_depth.set(len(self._queue))
            raise
        if stream:
            return TokenStream(self, req)
        return req

    def migrate_in(self, prompt_ids, *, seq_len=None, max_new_tokens=32,
                   arrival_time=None, spec_decode=None, sampling=None,
                   priority: int = 0, deadline_s: Optional[float] = None,
                   max_queue_delay_s: Optional[float] = None,
                   adapter: Optional[str] = None,
                   tenant: Optional[str] = None,
                   samp_base: Optional[np.ndarray] = None,
                   tokens=(), first_token_time: Optional[float] = None,
                   parcel: Optional[dict] = None) -> Request:
        """Adopt a request recovered from a failed replica, or handed off
        by a prefill-role one: the entry point of the router's failover
        and disaggregation.  Two paths:

        - ``parcel=None``: deterministic recompute from the prompt.  The
          request re-enters this engine's queue cold and re-runs prefill
          and decode from position 0.  Greedy rows are deterministic by
          construction; sampled rows replay bit-identically because
          ``samp_base`` carries the victim's PRNG base key (the
          position-keyed PRNG makes the restart free).
        - ``parcel={key, n_blocks, tok, lens, phase, pf_pos}``: exact-bytes
          KV migration.  The victim's swap parcel was already moved into
          THIS engine's host tier (``HostTier.transfer``, reason
          ``"preempt"``) and the request parks on the swap list as if
          this engine had preempted it: ``_try_resume`` allocates fresh
          blocks and re-scatters the saved bytes through the swap-in
          scatter, so the resumed stream is bit-identical to one that
          never moved.  ``tokens`` is the output emitted before the move
          (decode phase), ``tok``/``lens`` the slot's carries at its last
          consistent point.

        ``max_queue_delay_s`` belongs only to requests that were still
        queued on the victim (once admitted, a request runs to
        completion).  A full bounded queue refuses the recompute path
        with ``AdmissionError`` (the caller spills to another replica);
        parcel re-admissions join the swap list, which is never
        bounded."""
        ids = np.asarray(prompt_ids).reshape(-1).astype(np.int32)
        if ids.size < 1 or ids.size > self.prompt_len:
            raise ValueError(
                f"prompt must be 1..{self.prompt_len} tokens, got "
                f"{ids.size}")
        n = int(seq_len) if seq_len is not None else int(ids.size)
        if n < 1 or n > ids.size:
            raise ValueError(
                f"seq_len must be in [1, {ids.size}], got {n}")
        m = int(max_new_tokens)
        if m < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {m}")
        if n + m - 1 > self.max_cache_len:
            raise ValueError(
                f"prompt ({n}) + max_new_tokens ({m}) - 1 = {n + m - 1} "
                f"tokens exceeds max_cache_len ({self.max_cache_len}) "
                f"— migration requires replica-homogeneous geometry")
        if self._blocks_needed(n, m) > self.num_blocks:
            raise ValueError(
                f"request needs {self._blocks_needed(n, m)} blocks "
                f"but the pool only has num_blocks={self.num_blocks}")
        if sampling is not None:
            if not isinstance(sampling, SamplingParams):
                raise ValueError(
                    f"sampling must be a SamplingParams, got "
                    f"{type(sampling).__name__}")
            sampling.validate()
        sp = sampling if sampling is not None else self._default_sampling
        spec_k = None if spec_decode is None else int(spec_decode)
        if spec_k is not None:
            if spec_k < 1:
                raise ValueError(
                    f"spec_decode must be >= 1 draft tokens, got "
                    f"{spec_decode}")
            if sp is not None and sp.mask_processor is not None:
                raise ValueError(
                    "spec_decode cannot compose with a token-mask "
                    "processor: a draft position's mask depends on "
                    "host-side state the drafter bypasses — recover "
                    "the request without spec_decode")
        if adapter is not None:
            adapter = str(adapter)
            if self._adapters is None or \
                    self._adapters.state(adapter) is None:
                raise ValueError(
                    f"adapter {adapter!r} is not registered on this "
                    f"engine — migration requires replica-homogeneous "
                    f"adapter registration")
        if parcel is None and self.max_queue is not None and \
                len(self._queue) >= self.max_queue:
            raise AdmissionError(
                f"queue full ({len(self._queue)} >= max_queue="
                f"{self.max_queue}) — this engine refuses the "
                f"recovered request (spill to another replica)",
                queue_depth=len(self._queue), max_queue=self.max_queue)
        now = self._clock()
        arrival = now if arrival_time is None else float(arrival_time)
        padded = np.full((self.prompt_len,), self.cfg.pad_token_id,
                         np.int32)
        padded[:ids.size] = ids
        req = Request(self._next_id, padded, n, m, arrival,
                      pad_token_id=self.cfg.pad_token_id)
        req.submit_time = now
        req.spec_k = spec_k
        req.adapter = adapter
        req.tenant = "default" if tenant is None else str(tenant)
        self._tenant_served.setdefault(req.tenant, 0)
        req.sampling = sp
        req.priority = int(priority)
        req.deadline = (None if deadline_s is None
                        else arrival + float(deadline_s))
        req.max_queue_delay_s = (None if max_queue_delay_s is None
                                 else float(max_queue_delay_s))
        if sp is not None and not sp.is_greedy:
            # the victim's base key pins the stream (restart-exact);
            # without one this engine derives its own, as a fresh submit
            # does
            req.samp_base = (
                np.asarray(samp_base, np.uint32) if samp_base is not None
                else base_key(sp.seed) if sp.seed is not None
                else threefry.fold_in(threefry.as_key(
                    threefry.prng_key(self._seed)),
                    req.request_id).numpy().astype(np.uint32))
        req.chunk_ids = np.full((self.prompt_len + self.chunk_len,),
                                self.cfg.pad_token_id, np.int32)
        req.chunk_ids[:self.prompt_len] = padded
        if self.prefix_cache_mode == "digest":
            req.digests = _block_digests(padded, n, self.block_len,
                                         salt=self._digest_salt)
        if spec_k is not None:
            if self._drafter is None:
                self._drafter = NGramDrafter()
            self._spec_k_max = max(self._spec_k_max, spec_k)
        if parcel is not None:
            ent = self._host_tier.entry(int(parcel["key"]))
            if ent is None or ent.reason != "preempt":
                raise ValueError(
                    f"parcel key {parcel['key']!r} is not a preempt "
                    f"entry in this engine's host tier — transfer the "
                    f"victim's parcel first (HostTier.transfer)")
            if ent.n_blocks != int(parcel["n_blocks"]):
                raise ValueError(
                    f"parcel holds {ent.n_blocks} blocks but the swap "
                    f"record says {parcel['n_blocks']}")
            phase = str(parcel["phase"])
            if phase not in ("prefill", "decode"):
                raise ValueError(
                    f"parcel phase must be 'prefill' or 'decode', got "
                    f"{phase!r}")
            req.tokens = [int(x) for x in tokens]
            if phase == "decode":
                req.remaining = m - len(req.tokens)
                if req.remaining <= 0:
                    raise ValueError(
                        f"parcel carries {len(req.tokens)} emitted "
                        f"tokens of a {m}-token budget — nothing left "
                        f"to decode (the victim should have finished "
                        f"it)")
            req.pf_pos = int(parcel.get("pf_pos", 0))
            req.first_token_time = first_token_time
            req.swap = _SwapRecord(
                host_key=int(parcel["key"]),
                n_blocks=int(parcel["n_blocks"]),
                tok=int(parcel["tok"]), lens=int(parcel["lens"]),
                state=phase)
            req.state = "swapped"
            self._next_id += 1
            self._swapped.append(req)
            # the parcel entered this tier behind the engine's back
            # (HostTier.transfer from the router): settle the gauge now
            self._update_host_gauge()
            self._fr.emit("submit", req.request_id, self._step_idx,
                          seq_len=n, max_new=m, priority=req.priority,
                          migrated_blocks=int(parcel["n_blocks"]))
        else:
            # the recompute path re-enters the queue cold; submit's
            # unpin-on-error discipline applies to the prefix probe
            try:
                if self._radix is not None:
                    self._probe_radix(req)
                elif self.enable_prefix_cache:
                    self._match_prefix(req)
                if req.matched:
                    self._update_block_gauges()
                self._next_id += 1
                self._queue.append(req)
                self._fr.emit("submit", req.request_id, self._step_idx,
                              seq_len=n, max_new=m,
                              priority=req.priority,
                              queue_depth=len(self._queue),
                              recovered=1)
            except BaseException:
                if self._queue and self._queue[-1] is req:
                    self._queue.pop()
                for b in req.matched:
                    self._pool.unpin(b)
                req.matched = []
                for k in req.host_pins:
                    self._host_tier.unpin(k)
                req.host_pins = []
                self._update_block_gauges()
                raise
            self._m.queue_depth.set(len(self._queue))
            self._peak_queue = max(self._peak_queue, len(self._queue))
        self._m.requests_submitted.inc()
        return req

    def crash_reset(self) -> dict:
        """Model a replica restart after a fatal fault (kill, poisoned
        dispatch, permanent stall).  Every in-flight dispatch is dropped
        un-harvested, every live request is STRIPPED (returned by phase,
        with no terminal bookkeeping: the failover layer above owns its
        recovery now) and the whole memory system (block pool, tables,
        radix tree, host tier) comes back empty, as in a fresh engine
        over the same model.  Arena contents survive as garbage: every
        new occupant writes its KV before reading it.

        Pending device work goes without a wait on its events: the
        un-harvested ``_PendingBlock``s, the lazy demotion parcels and
        the pinned ring's claims.  Their buffers are safe to reuse,
        because the next dispatch and its host copies run on the same
        stream, behind whatever the dropped work still has in flight.

        Read any host-tier parcel to be migrated BEFORE calling this
        (``HostTier.transfer``): the reset replaces the tier.  The
        decode-block graphs, the verify programs and the request-id
        counter survive.  Returns ``{"queued": [..], "active": [..],
        "swapped": [..]}`` in scheduler order (handoff-ready requests
        count as swapped: their parcel is staged like a preemption's)."""
        stripped = {
            "queued": list(self._queue),
            "active": [r for r in self._slots if r is not None],
            "swapped": list(self._swapped) + list(self._handoff_ready),
        }
        for r in stripped["active"]:
            # an admitted request's adapter pin goes with it (the store
            # outlives the reset; its blocks go with the pool)
            if r.adapter_slot is not None:
                self._adapters.release(r.adapter)
                r.adapter_slot = None
        self._queue.clear()
        self._prefilling.clear()
        self._swapped = []
        self._handoff_ready = []
        self._pend_q.clear()
        for slot in self._ring:
            slot["busy"] = False
        self._lazy_parcels = []
        self._flush_finishes = []
        self._spec_fallback = set()
        self._fresh_memory()
        self._m.queue_depth.set(0)
        self._m.slot_occupancy.set(0)
        self._m.async_depth.set(0)
        self._update_block_gauges()
        self._update_host_gauge()
        return stripped

    def _match_prefix(self, req: Request):
        """Digest mode: extend ``req.matched`` with the published blocks
        of its next prompt digests (pinned), stopping at the first
        miss."""
        for dg in req.digests[len(req.matched):
                              (req.seq_len - 1) // self.block_len]:
            b = self._pool.lookup(dg)
            if b is None:
                break
            self._pool.pin(b)
            req.matched.append(b)

    def cancel(self, request_id: int) -> bool:
        """Drop a request from any live phase.  Queued: removed from the
        queue, its prefix pins released.  Swapped: its host-RAM copy is
        dropped (its blocks were freed at preemption).  In flight
        (prefill or decode): the slot freezes (``done`` plus an
        all-trash table row) and its blocks release now.  A cancelled
        request is terminal like shed and timeout: ``finish_time`` set,
        output padded to ``max_new_tokens``.  Returns False for unknown
        or already-terminal requests."""
        now = self._clock()
        for req in self._queue:
            if req.request_id == request_id:
                self._drop_queued(req, now, "cancelled")
                self._m.requests_cancelled.inc(phase="queued")
                _span_instant("serving.request.cancel",
                              request=req.request_id, phase="queued")
                self._fr.emit("cancel", req.request_id, self._step_idx,
                              phase="queued")
                return True
        for req in self._swapped:
            if req.request_id == request_id:
                self._swapped.remove(req)
                self._host_tier.drop(req.swap.host_key)
                self._update_host_gauge()
                req.swap = None
                self._terminate(req, now, "cancelled")
                self._m.requests_cancelled.inc(phase="swapped")
                _span_instant("serving.request.cancel",
                              request=req.request_id, phase="swapped")
                self._fr.emit("cancel", req.request_id, self._step_idx,
                              phase="swapped")
                return True
        for i, req in enumerate(self._slots):
            if req is not None and req.request_id == request_id:
                # only an IN-FLIGHT cancel needs host truth (the output
                # pads from the tokens that already exist, and a pending
                # harvest must not outlive its riding set)
                self._flush_async("cancel")
                if req.state in TERMINAL_STATES:
                    # the flush itself retired it (its finish bit was
                    # already set on the device, depth >= 2): it
                    # FINISHED, and the already-terminal contract holds
                    # (the finish reaches the next step()'s return)
                    return False
                phase = req.state
                if req in self._prefilling:
                    self._prefilling.remove(req)
                self._release_blocks(req)   # also trashes the table row
                self._slots[i] = None
                self._done[i] = True
                req.slot = None
                self._terminate(req, now, "cancelled")
                self._m.requests_cancelled.inc(phase=phase)
                self._set_occupancy()
                _span_instant("serving.request.cancel",
                              request=req.request_id, phase=phase)
                self._fr.emit("cancel", req.request_id, self._step_idx,
                              phase=phase)
                return True
        return False

    # -- scheduler --
    def _finish(self, req: Request, t: float, out: List[Request],
                lag: int = 0):
        req.finish_time = t
        req.state = "finished"
        if req.slot is not None:
            self._m.evictions.inc()
        req.slot = None
        self._m.requests_finished.inc()
        if req.latency is not None:
            self._m.latency.observe(req.latency)
        # per-output-token latency (TPOT), one observation per request
        # with >= 2 tokens
        n_out = len(req.tokens)
        req.n_emitted = n_out
        if req.first_token_time is not None and n_out >= 2:
            self._m.tpot.observe(
                (t - req.first_token_time) / (n_out - 1))
        self._slo_account(req)
        _span_instant("serving.request.finish", request=req.request_id,
                      tokens=len(req.tokens))
        # a deferred harvest observed this finish ``lag`` steps after the
        # device produced it: the event is stamped with the DISPATCH
        # step and the lag attr is a deterministic step delta
        fattrs = {"tokens": n_out}
        if lag:
            fattrs["lag"] = lag
        self._fr.emit("finish", req.request_id,
                      self._step_idx - lag, **fattrs)
        # pad the stream out to max_new_tokens (the static generate()
        # convention: pad after EOS) so output shapes are uniform
        req.tokens.extend(
            [self.cfg.pad_token_id] *
            (req.max_new_tokens - len(req.tokens)))
        self._finished.append(req)
        out.append(req)

    @staticmethod
    def _sched_key(r: Request):
        """Admission order (smaller admits first): highest priority,
        then earliest deadline; the stable sort keeps FIFO within a
        class."""
        return (-r.priority, r.deadline if r.deadline is not None
                else _INF)

    @staticmethod
    def _shed_key(r: Request):
        """"Worseness" (smaller = worse = shed/preempt first): lowest
        priority, then latest deadline (no deadline = latest)."""
        return (r.priority, _neg_deadline(r.deadline))

    @staticmethod
    def _remaining_work(r: Request) -> int:
        """Victim tie-breaker: tokens of compute still owed (prompt
        positions left to prefill plus the decode budget)."""
        if r.state == "prefill":
            return (r.seq_len - r.pf_pos) + r.max_new_tokens
        return r.remaining

    def _terminate(self, req: Request, now: float, state: str):
        """Mark a request terminal without it running to completion —
        the one terminal shape of shed, timeout and cancel: terminal
        state, ``finish_time`` set, output padded to exactly
        ``max_new_tokens``."""
        req.state = state
        req.finish_time = now
        req.tokens.extend([self.cfg.pad_token_id]
                          * (req.max_new_tokens - len(req.tokens)))
        # shed/timeout are SLO outcomes (missed); cancel is skipped
        # inside _slo_account by state
        self._slo_account(req)

    def _drop_queued(self, req: Request, now: float, state: str):
        """The one teardown of a queued request leaving without running
        (shed, timed out or cancelled): off the queue, its prefix pins
        (HBM blocks and host parcels) released, terminal.  The caller
        counts it."""
        self._queue.remove(req)
        for b in req.matched:
            self._pool.unpin(b)
        req.matched = []
        for k in req.host_pins:
            self._host_tier.unpin(k)
        req.host_pins = []
        self._terminate(req, now, state)
        self._m.queue_depth.set(len(self._queue))
        self._update_block_gauges()

    def _shed(self, req: Request, now: float):
        """Displace a queued request from a full bounded queue."""
        self._drop_queued(req, now, "shed")
        self._m.shed.inc(reason="evicted")
        _span_instant("serving.request.shed", request=req.request_id)
        self._fr.emit("shed", req.request_id, self._step_idx)

    def _sweep_timeouts(self, now: float, out: List[Request]):
        """Finish queued requests whose wait exceeded their
        ``max_queue_delay_s`` with state ``"timeout"``.  Only queued
        requests time out: admitted (and swapped) ones always
        complete."""
        for r in [r for r in self._queue
                  if r.max_queue_delay_s is not None
                  and now - r.arrival_time > r.max_queue_delay_s]:
            self._drop_queued(r, now, "timeout")
            self._m.timeouts.inc()
            _span_instant("serving.request.timeout",
                          request=r.request_id,
                          waited_ms=round((now - r.arrival_time) * 1e3, 3))
            # no waited_ms attr here: flight-recorder attrs stay
            # wall-free so replayed traces compare event-identical
            self._fr.emit("timeout", r.request_id, self._step_idx)
            out.append(r)

    # -- preemption + host-RAM swap --
    def _preempt(self, req: Request, reason: str = "pressure",
                 out=None) -> bool:
        """Swap an in-flight request out to the host-RAM tier: gather
        its blocks' exact at-rest bytes, save the slot's ``tok``/``lens``
        carries, release its blocks and park it on the swap list.  Its
        host truth (``tokens``, ``pf_pos``) needs no saving.  Returns
        False when the harvest flush itself retired the victim (its
        finish was already on the device, depth >= 2), True after a
        swap-out."""
        # the swap record saves the slot's HOST carries: a deferred
        # harvest must land first, and before validating, since at depth
        # >= 2 the flush can discover that the victim finished
        self._flush_async("preempt", out)
        slot = req.slot
        if req.state in TERMINAL_STATES:
            return False
        if slot is None or req.state not in ("prefill", "decode"):
            raise RuntimeError(
                f"request {req.request_id} is not in flight "
                f"(state={req.state}, slot={slot}) — only admitted "
                f"prefill/decode requests can be preempted")
        ids = self._tables[slot].copy()     # before release trashes it
        n = len(req.blocks)
        with _span("serving.swap_out", request=req.request_id, blocks=n):
            rows, dtypes = self._gather_rows(ids, n)
        key = self._host_tier.put(rows, n, "preempt", dtypes)
        req.swap = _SwapRecord(host_key=key, n_blocks=n,
                               tok=int(self._tok[slot]),
                               lens=int(self._lens[slot]),
                               state=req.state)
        if req in self._prefilling:
            self._prefilling.remove(req)
        self._release_blocks(req)
        self._slots[slot] = None
        self._done[slot] = True
        req.slot = None
        req.state = "swapped"
        req.preempt_count += 1
        self._swapped.append(req)
        nbytes = n * self.block_len * self._kv_row_bytes
        self._m.preempts.inc()
        self._m.swap_out_blocks.inc(n, reason="preempt")
        self._m.swap_out_bytes.inc(nbytes, reason="preempt")
        self._update_host_gauge()
        self._set_occupancy()
        _span_instant("serving.request.preempt", request=req.request_id,
                      blocks=n, reason=reason)
        self._fr.emit("preempt", req.request_id, self._step_idx,
                      blocks=n, reason=reason, phase=req.swap.state)
        self._fr.emit("swap_out", req.request_id, self._step_idx,
                      blocks=n, reason="preempt")
        return True

    def _preempt_for(self, cand: Request, needed: int, out=None) -> bool:
        """Free blocks for ``cand`` by swapping out strictly-worse
        victims (lowest priority first, then latest deadline, then most
        remaining work) until ``needed`` blocks are allocatable.  Strict
        eligibility means a resumed victim never preempts its preemptor
        back and equal requests never thrash.  Returns True when the
        target was reached."""
        cand_key = self._shed_key(cand)
        while self._pool.available() < needed:
            eligible = [
                r for r in self._slots
                if r is not None and r.state in ("prefill", "decode")
                and self._shed_key(r) < cand_key]
            if not eligible:
                return False
            victim = min(eligible, key=lambda v: (
                self._shed_key(v) + (-self._remaining_work(v),)))
            self._preempt(victim, out=out)
        return True

    def _try_resume(self, req: Request, slot: int, out=None) -> bool:
        """Re-admit a swapped request: allocate fresh blocks (with the
        valve and preemption under pressure), re-scatter the saved bytes
        and restore the slot carries.  The fresh blocks keep the logical
        block order, so the resumed stream is bit-identical to one never
        preempted."""
        rec = req.swap
        # the adapter pin was released at preemption (a swapped request
        # needs no arena residency): re-acquire it before any block work.
        # No free slot leaves a valid swap-list member, as block
        # exhaustion does
        acquired = False
        if req.adapter is not None:
            if self._adapters.acquire(req.adapter) is None:
                return False
            acquired = True
        fresh = self._alloc(rec.n_blocks)
        if fresh is None and \
                not any(r is not None for r in self._slots):
            self._release_queue_pins()
            fresh = self._alloc(rec.n_blocks)
        if fresh is None and self.enable_preemption and \
                self._preempt_for(req, rec.n_blocks, out):
            fresh = self._alloc(rec.n_blocks)
        if fresh is None:
            if acquired:
                self._adapters.release(req.adapter)
            return False
        # the resume REWRITES the slot's host carries, so the next decode
        # dispatch must come from host mirrors: harvest first.  Flushed
        # only here, after the blocks are secured: an attempt that cannot
        # allocate keeps the pipeline deferred
        self._flush_async("resume", out)
        row = np.full((self.max_blocks,), self._pool.trash, np.int32)
        row[:rec.n_blocks] = fresh
        # the scatter runs before any scheduler state changes; a failure
        # unpins the fresh blocks and leaves a valid swap-list member
        try:
            ent = self._host_tier.entry(rec.host_key)
            self._resolve_entries([ent])
            with _span("serving.swap_in", request=req.request_id,
                       blocks=rec.n_blocks):
                self._scatter_rows(row, ent.rows, ent.dtypes)
        except BaseException:
            for b in fresh:
                self._pool.unpin(b)
            if acquired:
                self._adapters.release(req.adapter)
            self._update_block_gauges()
            raise
        self._swapped.remove(req)
        if acquired:
            req.adapter_slot = self._adapters.slot_of(req.adapter)
        req.blocks = list(fresh)
        req.matched = []
        self._tables[slot] = row
        req.slot = slot
        self._slots[slot] = req
        self._tok[slot] = rec.tok
        self._lens[slot] = rec.lens
        req.state = rec.state
        if rec.state == "prefill":
            self._done[slot] = True       # not decoding yet
            self._prefilling.append(req)
        else:
            # spec-mode rows stay frozen out of the plain decode block
            # (their progress happens in the verify forward)
            self._done[slot] = req.spec_k is not None
        req.swap = None
        self._host_tier.drop(rec.host_key)
        self._m.preempt_resumes.inc()
        self._m.swap_in_blocks.inc(rec.n_blocks, reason="preempt")
        self._m.swap_in_bytes.inc(
            rec.n_blocks * self.block_len * self._kv_row_bytes,
            reason="preempt")
        self._update_host_gauge()
        self._update_block_gauges()
        _span_instant("serving.request.resume", request=req.request_id,
                      slot=slot, blocks=rec.n_blocks)
        self._fr.emit("swap_in", req.request_id, self._step_idx,
                      blocks=rec.n_blocks, reason="preempt", slot=slot)
        return True

    def _release_queue_pins(self):
        """Head-of-line valve: nothing is running, so drop every queued
        request's prefix pins (HBM blocks and host parcels) so a cold,
        full-width allocation can succeed."""
        for r in self._queue:
            for b in r.matched:
                self._pool.unpin(b)
            r.matched = []
            for k in r.host_pins:
                self._host_tier.unpin(k)
            r.host_pins = []
            r.rspan = []
            r.rmatch_tokens = 0   # else a valve (cold) admission would
            #                       count a spurious partial hit

    # -- radix prefix cache (tiered) --
    def _probe_radix(self, req: Request):
        """Probe the radix tree for ``req``'s prompt and pin the matched
        span: HBM blocks against pool reclaim (``req.matched``), host
        parcels against tier eviction (``req.host_pins``).  The span is
        capped at the block before the prompt's last token, whose hidden
        state samples the first output token."""
        n = req.seq_len
        m_tok, span = self._radix.match(req.prompt[:n])
        span = span[:(n - 1) // self.block_len]
        self._radix.touch_span(span)
        for kind, ref in span:
            if kind == "hbm":
                self._pool.pin(ref)
                req.matched.append(ref)
            else:
                self._host_tier.pin(ref)
                req.host_pins.append(ref)
        req.rmatch_tokens = min(m_tok, n - 1)
        req.rspan = span

    def _reprobe_radix(self, req: Request):
        """Admission-time revalidation of the submit-time probe: the
        tree may have grown, demoted spans to host or promoted them
        back.  Old pins release first so pin accounting stays exact.
        An armed swap-in fault degrades the span here, before the
        allocation is sized: the host parcels drop (their bytes are what
        "failed") and the span truncates to its directly mapped HBM
        prefix, so the request recomputes the tail — a prefix miss,
        never a wedge or a token drift."""
        for b in req.matched:
            self._pool.unpin(b)
        req.matched = []
        for k in req.host_pins:
            self._host_tier.unpin(k)
        req.host_pins = []
        self._probe_radix(req)
        if any(kind == "host" for kind, _ in req.rspan) and \
                self._fault is not None and \
                self._fault.take_swapin_failure():
            keep = []
            for kind, ref in req.rspan:
                if kind != "hbm":
                    break
                keep.append((kind, ref))
            for kind, ref in req.rspan[len(keep):]:
                if kind == "hbm":
                    self._pool.unpin(ref)
                    req.matched.remove(ref)
                else:
                    self._host_tier.unpin(ref)
                    req.host_pins.remove(ref)
                    self._host_tier.drop(ref)
                    self._radix.drop_host(ref)
            req.rspan = keep
            self._update_host_gauge()
        self._update_block_gauges()

    def _map_radix_span(self, req: Request, fresh: List[int]):
        """Resolve the matched span into arena blocks: HBM entries map
        directly, host entries are PROMOTED — their exact at-rest bytes
        re-scatter into the leading ``fresh`` blocks and the tree
        relabels them HBM-resident.  Returns ``(mapped, leftover_fresh,
        n_promoted)``.  A raise mid-promotion unpins every fresh block
        and releases the request's probe pins, leaving a valid queue
        member that holds nothing."""
        span = req.rspan
        host_keys = [ref for kind, ref in span if kind == "host"]
        n_promote = len(host_keys)
        if n_promote:
            dest = fresh[:n_promote]
            entries = [self._host_tier.entry(k) for k in host_keys]
            self._resolve_entries(entries)
            ids_row = np.full((self.max_blocks,), self._pool.trash,
                              np.int32)
            ids_row[:n_promote] = dest
            try:
                with _span("serving.cache_swap_in",
                           request=req.request_id, blocks=n_promote):
                    self._scatter_rows(ids_row, [
                        np.concatenate([e.rows[ai] for e in entries],
                                       axis=0)
                        for ai in range(len(self._arenas))],
                        entries[0].dtypes)
            except BaseException:
                for b in fresh:
                    self._pool.unpin(b)
                for b in req.matched:
                    self._pool.unpin(b)
                req.matched = []
                for k in req.host_pins:
                    self._host_tier.unpin(k)
                req.host_pins = []
                req.rspan = []
                req.rmatch_tokens = 0
                self._update_block_gauges()
                raise
            for k, b in zip(host_keys, dest):
                self._host_tier.unpin(k)       # the probe pin
                self._radix.promote(k, b)      # consumes the parcel
                req.host_pins.remove(k)
            nbytes = n_promote * self.block_len * self._kv_row_bytes
            self._m.swap_in_blocks.inc(n_promote, reason="cache")
            self._m.swap_in_bytes.inc(nbytes, reason="cache")
            self._m.prefix_host_hits.inc()
            self._m.prefix_host_swapin.inc(n_promote)
            self._fr.emit("swap_in", req.request_id, self._step_idx,
                          blocks=n_promote, reason="cache")
            self._update_host_gauge()
        it = iter(fresh[:n_promote])
        mapped = [ref if kind == "hbm" else next(it)
                  for kind, ref in span]
        return mapped, fresh[n_promote:], n_promote

    def _residency_rank(self, r: Request) -> int:
        """Fresh radix probe (no pinning) classifying a queued request's
        matched prefix: 0 = some of it is HBM-resident, 1 = host-resident
        only, 2 = cold."""
        _m, span = self._radix.match(r.prompt[:r.seq_len])
        span = span[:(r.seq_len - 1) // self.block_len]
        if any(kind == "hbm" for kind, _ in span):
            return 0
        return 1 if span else 2

    def prefix_match(self, prompt_ids) -> int:
        """Token-granular longest-prefix match of ``prompt_ids`` against
        this engine's radix tree (0 outside radix mode); read-only (no
        pin, no LRU touch)."""
        if self._radix is None:
            return 0
        ids = np.asarray(prompt_ids).reshape(-1).astype(np.int32)
        matched, _span = self._radix.match(ids)
        return int(matched)

    def _admit(self, now: float, out: List[Request]):
        """Admit the best-class candidates into vacant slots.  Queue-
        delay timeouts are swept first.  Candidates are the swap list
        plus the arrived queue, ordered priority-then-EDF; within a class
        swapped requests come first, then queued ones whose matched
        prefix is HBM-resident, then host-resident, then cold (radix
        mode), FIFO inside each rank.  Between class and rank sits the
        fair-share term: the least weight-normalized-served tenant admits
        first (deficit-weighted round-robin, a constant on a single
        tenant).  An adapter request pins its adapter's arena slot before
        its blocks are sized; no free slot waits, as block exhaustion
        does.  When the pool cannot serve the head
        candidate, the head-of-line valve (nothing running) and then
        preemption of strictly-worse victims are tried before giving up
        until blocks retire; a stuck head is never skipped for a worse
        candidate that would fit.  ``static_batching`` admits only into
        an EMPTY pool (the gang baseline)."""
        self._sweep_timeouts(now, out)
        if self.static_batching and \
                any(r is not None for r in self._slots):
            return
        ranks: dict = {}

        def _state_rank(r):
            # probed once per candidate per call: the tree only improves
            # mid-call, and a stale rank costs order, never correctness
            if r.state == "swapped":
                return -1
            if self._radix is None:
                return 0
            rank = ranks.get(r.request_id)
            if rank is None:
                rank = self._residency_rank(r)
                ranks[r.request_id] = rank
            return rank

        def _cand_key(r):
            # the fair term is read anew each time: every admission
            # charges its tenant, and the next pick must see the ledger
            return (self._sched_key(r) + (self._fair_norm(r.tenant),)
                    + (_state_rank(r),))

        def _fifo_key(r):
            # the order without the fair term: a different head is a
            # counted reorder
            return self._sched_key(r) + (_state_rank(r),)

        while True:
            slot = next((i for i, r in enumerate(self._slots)
                         if r is None), None)
            if slot is None:
                break
            arrived = [r for r in self._queue if r.arrival_time <= now]
            cands = sorted(self._swapped + arrived, key=_cand_key)
            if not cands:
                break
            req = cands[0]
            # a "reorder": the fair term promoted another request over
            # the plain head; possible only with more than one tenant
            # (min() over submission order is the stable sort's head)
            reorder = (len(self._tenant_served) > 1 and
                       req is not min(self._swapped + arrived,
                                      key=_fifo_key))
            if req.state == "swapped":
                if not self._try_resume(req, slot, out):
                    break
                if reorder:
                    # a fairness-promoted resume is a reorder too
                    self._m.fairshare_reorders.inc()
                continue
            if self._radix is not None:
                # the tree may have grown while this request queued:
                # re-probe and re-pin before sizing the allocation
                self._reprobe_radix(req)
            elif self.enable_prefix_cache:
                # blocks published between submit and now may extend
                # the match
                self._match_prefix(req)
            n_hbm = len(req.matched)
            # adapter residency before block sizing: the gathered
            # dispatch needs the arena slot pinned for the request's
            # admitted life
            acquired = False
            if req.adapter is not None:
                if self._adapters.acquire(req.adapter) is None:
                    break
                acquired = True
            total = self._blocks_needed(req.seq_len, req.max_new_tokens)
            fresh = self._alloc(total - n_hbm)
            if fresh is None and \
                    not any(r is not None for r in self._slots):
                # head-of-line valve: a cold, full-width admission
                self._release_queue_pins()
                n_hbm = 0
                fresh = self._alloc(total)
            if fresh is None and self.enable_preemption and \
                    self._preempt_for(req, total - n_hbm, out):
                fresh = self._alloc(total - n_hbm)
            if fresh is None:
                if acquired:
                    self._adapters.release(req.adapter)
                break                     # pool drains as requests retire
            matchable = ((req.seq_len - 1) // self.block_len
                         if self.enable_prefix_cache else 0)
            if self._radix is not None:
                # a raise leaves the request queued with its fresh blocks
                # unpinned (_map_radix_span's rollback); the adapter pin
                # rolls back with them
                try:
                    mapped, fresh, n_promoted = self._map_radix_span(
                        req, fresh)
                except BaseException:
                    if acquired:
                        self._adapters.release(req.adapter)
                    raise
                req.blocks = mapped + fresh
                hit_tokens = len(mapped) * self.block_len
                self._m.prefix_hit_tokens.inc(hit_tokens)
                partial = req.rmatch_tokens > hit_tokens
                if partial:
                    self._m.prefix_partial_hits.inc()
                # goodput: positions the tree matched token-level but
                # could not map are recomputed by the prefill — charged
                # wasted{recompute_cache} as they compute
                req.gp_recompute_from = hit_tokens
                req.gp_recompute_to = max(hit_tokens, req.rmatch_tokens)
                if mapped or partial:
                    # tier rides the ACTUAL promotion count, never the
                    # pre-map span shape
                    self._fr.emit(
                        "prefix_hit", req.request_id, self._step_idx,
                        tier=("host" if n_promoted else
                              "hbm" if mapped else "partial"),
                        blocks=len(mapped), tokens=hit_tokens,
                        partial=int(partial))
                req.matched = []
                req.rspan = []
            else:
                mapped = req.matched
                req.blocks = req.matched + fresh
                self._m.prefix_hit_tokens.inc(len(mapped) * self.block_len)
                if mapped:
                    self._fr.emit(
                        "prefix_hit", req.request_id, self._step_idx,
                        tier="hbm", blocks=len(mapped),
                        tokens=len(mapped) * self.block_len, partial=0)
            self._queue.remove(req)
            if acquired:
                req.adapter_slot = self._adapters.slot_of(req.adapter)
            # fair-share bookkeeping at the admission decision: the
            # deficit is the tenant's shortfall against the most-served
            # tenant BEFORE this admission's charge; default-tenant
            # traces carry no extra attrs
            extra = {}
            if req.adapter is not None:
                extra["adapter"] = req.adapter
            if req.tenant != "default" or reorder:
                top = max(self._fair_norm(t) for t in self._tenant_served)
                extra["tenant"] = req.tenant
                extra["deficit"] = round(
                    top - self._fair_norm(req.tenant), 3)
            if reorder:
                self._m.fairshare_reorders.inc()
            self._charge_tenant(req)
            self._m.prefix_hits.inc(len(mapped))
            self._m.prefix_misses.inc(matchable - len(mapped))
            row = np.full((self.max_blocks,), self._pool.trash, np.int32)
            row[:len(req.blocks)] = req.blocks
            self._tables[slot] = row
            req.slot = slot
            req.state = "prefill"
            req.pf_pos = len(mapped) * self.block_len
            self._slots[slot] = req
            self._done[slot] = True       # not decoding yet
            self._lens[slot] = 0
            self._prefilling.append(req)
            self._m.queue_depth.set(len(self._queue))
            self._update_block_gauges()
            _span_instant("serving.request.admit", request=req.request_id,
                          slot=slot, matched_blocks=len(mapped))
            self._fr.emit("admit", req.request_id, self._step_idx,
                          slot=slot, matched_blocks=len(mapped), **extra)
        self._set_occupancy()

    # -- fair share (deficit-weighted round-robin over tenants) --
    def _fair_norm(self, tenant: str) -> float:
        """A tenant's weight-normalized service: tokens charged at
        admission over its weight.  The least-normalized-served tenant in
        a scheduling class admits next; integer token counts over fixed
        weights keep the order deterministic."""
        return (self._tenant_served.get(tenant, 0)
                / self._tenant_weights.get(tenant, 1.0))

    def _update_deficits(self):
        """Refresh the per-tenant deficit gauges: the most-served tenant's
        normalized service minus each tenant's own (>= 0)."""
        if not self._tenant_served:
            return
        top = max(self._fair_norm(t) for t in self._tenant_served)
        for t in self._tenant_served:
            self._m.fairshare_deficit.set(
                round(top - self._fair_norm(t), 3), tenant=t)

    def _charge_tenant(self, req: Request):
        """Charge a request leaving the queue its reservation (prompt +
        decode budget) to its tenant's ledger: the round-robin's step."""
        cost = req.seq_len + req.max_new_tokens
        self._tenant_served[req.tenant] = \
            self._tenant_served.get(req.tenant, 0) + cost
        self._m.fairshare_served.inc(cost, tenant=req.tenant)
        self._update_deficits()

    def _prefill_chunk(self, out: List[Request]):
        """Run at most ONE prompt chunk (FIFO over admissions).  The
        final chunk samples the request's first token and moves it into
        the decode mix; completed full blocks are published to the
        prefix cache as soon as they are written."""
        if not self._prefilling:
            return
        req = self._prefilling[0]
        start, c = req.pf_pos, self.chunk_len
        is_final = start + c >= req.seq_len
        if is_final:
            # the final chunk samples the first token, host truth THIS
            # step (EOS check, decode-mix entry, the slot's carries)
            self._flush_async("chunk_final", out)
        flags, planes = self._build_samp([req])
        lora = self._build_lora([req])
        t0 = self._clock()
        with _span("serving.prefill", request=req.request_id,
                   slot=req.slot, start=start):
            outp = chunk_prefill(
                self._model,
                self._dev(req.chunk_ids[None, start:start + c]),
                start, req.seq_len,
                self._dev(self._tables[req.slot][None, :]),
                self._arenas, wq=self._wq_ctx,
                samp=self._samp_tensors(planes), flags=flags, lora=lora)
            # a non-final chunk's token means nothing: the dispatch-
            # ahead engine leaves it on the device and the chunk runs
            # under the next iterations' host work
            tok0 = (int(self._fetch(outp[:1])[0][0])
                    if is_final or not self.async_dispatch else None)
        self._m.prefill_chunks.inc()
        dt = self._clock() - t0
        self._m.chunk_latency.observe(dt)
        self._disp_s += dt
        self._count_kv_sweep([min(start + c, req.seq_len) - 1])
        self._count_weight_sweep(1)
        # goodput: the dispatch computed chunk_len positions for this
        # row — valid prompt positions split first-time-useful vs
        # cache-known recompute, the grid tail past seq_len is pad
        valid = min(start + c, req.seq_len) - start
        rc = max(0, (min(start + valid, req.gp_recompute_to)
                     - max(start, req.gp_recompute_from)))
        self._ledger(valid - rc, tenant=req.tenant,
                     recompute_cache=rc, pad=c - valid)
        self._fr.emit("prefill_chunk", req.request_id, self._step_idx,
                      start=start, tokens=valid)
        req.pf_pos = start + c
        full = min(req.pf_pos, req.seq_len) // self.block_len
        if self._radix is not None:
            if full > req.registered:
                # token runs and block spans enter the tree as soon as
                # the blocks are fully written (first writer wins)
                self._radix.insert(req.prompt, req.blocks, full,
                                   start_block=req.registered)
                req.registered = full
        elif self.enable_prefix_cache:
            while req.registered < min(full, len(req.digests)):
                i = req.registered
                self._pool.register(req.blocks[i], req.digests[i])
                req.registered = i + 1
        if req.pf_pos < req.seq_len:
            return                        # more chunks to go
        self._prefilling.popleft()
        self._m.prefills.inc()
        self._m.tokens_emitted.inc()
        t = self._clock()
        req.first_token_time = t
        if req.ttft is not None:
            self._m.ttft.observe(req.ttft)
        req.tokens.append(tok0)
        req.remaining = req.max_new_tokens - 1
        self._count_sample_route([(req, 1)])
        slot = req.slot
        if (self.cfg.eos_token_id is not None and
                tok0 == self.cfg.eos_token_id) or req.remaining == 0 or (
                    req.sampling is not None
                    and req.sampling.mask_processor is not None
                    and self._mask_dead_end(req)):
            # finished at the first token (EOS, budget, or a grammar
            # complete after it): never enters the decode mix
            self._slots[slot] = None
            self._done[slot] = True
            self._release_blocks(req)
            self._finish(req, t, out)
            return
        if self.role == "prefill":
            # the disaggregation point: a prefill-role replica never
            # decodes in place; the request's KV parcel is staged for the
            # router and a decode replica resumes it through migrate_in
            # and _try_resume (tok0 travels in the parcel's tok carry)
            self._handoff_out(req, tok0, slot)
            return
        req.state = "decode"
        self._tok[slot] = tok0
        self._lens[slot] = req.seq_len
        # spec-mode rows never ride the plain decode block: their row
        # stays done there (frozen lens, trash-routed writes) and all
        # progress happens in the verify forward, which reads host truth
        self._done[slot] = req.spec_k is not None

    def _handoff_out(self, req: Request, tok0: int, slot: int):
        """Chunk-final handoff swap-out (prefill-role engines only): the
        ``_preempt`` gather at the moment the final chunk sampled
        ``tok0``, into the host tier with the DECODE-phase carries
        (``tok=tok0``, ``lens=seq_len``), blocks and slot released; the
        request parks on the handoff-ready list for ``take_handoffs()``
        instead of this engine's swap list.  The final chunk already
        synced (reason ``chunk_final``), so no flush is needed.

        Unlike a preemption's, the gather is left LAZY: it is enqueued on
        the engine's stream (a copy out of the arenas, ahead of any later
        write to the released blocks) with its copy into pinned host
        memory, and the parcel's rows materialize where the bytes are
        first read, the router's ``HostTier.transfer`` or the wire's
        parcel shipment, not inside this step."""
        ids = self._tables[slot].copy()     # before release trashes it
        n = len(req.blocks)
        with _span("serving.handoff_out", request=req.request_id,
                   blocks=n):
            lazy, dtypes = self._gather_rows(ids, n, materialize=False)
        key = self._host_tier.put(lazy.resolve, n, "preempt", dtypes)
        req.swap = _SwapRecord(host_key=key, n_blocks=n, tok=int(tok0),
                               lens=int(req.seq_len), state="decode")
        self._release_blocks(req)
        self._slots[slot] = None
        self._done[slot] = True
        req.slot = None
        req.state = "swapped"
        self._handoff_ready.append(req)
        nbytes = n * self.block_len * self._kv_row_bytes
        self._m.handoff_requests.inc(reason="chunk_final")
        self._m.handoff_blocks.inc(n)
        self._m.handoff_bytes.inc(nbytes)
        self._update_host_gauge()
        self._set_occupancy()
        _span_instant("serving.request.handoff", request=req.request_id,
                      blocks=n)
        self._fr.emit("handoff", req.request_id, self._step_idx,
                      blocks=n, reason="chunk_final")

    def take_handoffs(self) -> List[Request]:
        """Drain the chunk-final handoff staging: requests whose KV
        parcel awaits a decode replica (state ``"swapped"``, parcel in
        this engine's host tier under ``req.swap.host_key``).  The caller
        (the router's handoff orchestration) owns them after this call:
        it transfers each parcel and places the request through the
        destination's ``migrate_in``.  Empty on every step of a
        ``"both"`` or ``"decode"`` engine."""
        out, self._handoff_ready = self._handoff_ready, []
        return out

    def _build_samp(self, reqs, pos_lag: int = 0):
        """The sampling planes of one dispatch as host arrays: ``reqs`` is
        the dispatch's batch view (one Optional[Request] per row; None =
        vacant, frozen or not riding).  The flags come from the riding
        rows only; other rows get neutral values (greedy, temperature 1,
        zero bias), their draws computed and discarded.  PRNG positions
        are re-derived from host truth (``len(req.tokens)``) every
        dispatch, which rewinds a speculative rollback for free;
        ``pos_lag`` corrects that truth on a deferred dispatch (the
        pending steps' tokens are not harvested yet).  A penalty or bias
        plane under lag raises: such rows force a sync.  Returns
        ``(flags, planes)``."""
        flags = flags_of([r.sampling for r in reqs if r is not None])
        sampled, _filtered, penalty, bias = flags
        if pos_lag and (penalty or bias):
            raise RuntimeError(
                "deferred dispatch with a host-built logit plane "
                "(penalty/bias) — the defer predicate must have forced a "
                "sync for these rows")
        n = len(reqs)
        planes = {}
        if sampled:
            base = np.zeros((n, 2), np.int64)
            pos = np.zeros((n,), np.int64)
            temp = np.ones((n,), np.float32)
            top_k = np.zeros((n,), np.int64)
            top_p = np.ones((n,), np.float32)
            greedy = np.ones((n,), bool)
            for i, r in enumerate(reqs):
                if r is None:
                    continue
                temp[i], top_k[i], top_p[i], greedy[i] = \
                    row_planes(r.sampling)
                pos[i] = len(r.tokens) + pos_lag
                if r.samp_base is not None:
                    base[i] = r.samp_base
            planes.update(base=base, pos=pos, temp=temp, top_k=top_k,
                          top_p=top_p, greedy=greedy)
        if penalty:
            rep = np.ones((n,), np.float32)
            presence = np.zeros((n, self._vocab), bool)
            for i, r in enumerate(reqs):
                if r is None or r.sampling is None \
                        or not r.sampling.needs_penalty:
                    continue
                rep[i] = r.sampling.repetition_penalty
                presence[i, r.prompt[:r.seq_len]] = True
                if r.tokens:
                    presence[i, np.asarray(r.tokens, np.int32)] = True
            planes.update(rep=rep, presence=presence)
        if bias:
            bias_p = np.zeros((n, self._vocab), np.float32)
            for i, r in enumerate(reqs):
                if r is None or r.sampling is None \
                        or r.sampling.mask_processor is None:
                    continue
                allowed = np.asarray(r.sampling.mask_processor.allowed(),
                                     bool)
                bias_p[i, ~allowed] = MASK_BIAS
            planes["bias"] = bias_p
        return flags, planes

    def _build_lora(self, reqs) -> Optional[dict]:
        """The ``lora`` planes of one dispatch (``models/lora.py``):
        ``reqs`` is the dispatch's batch view, as ``_build_samp``'s.  None
        when no riding row selected an adapter, so an adapter-free
        dispatch runs today's program.  Rows without an adapter name the
        arenas' all-zero null row: their delta is an exact ``+ 0.0``.  The
        ids reach the device from pinned host staging (``_dev``); the
        arenas are the store's own tensors."""
        if self._adapters is None or not any(
                r is not None and r.adapter is not None for r in reqs):
            return None
        ids = np.full((len(reqs),), self._adapters.null_slot, np.int32)
        for i, r in enumerate(reqs):
            if r is not None and r.adapter is not None:
                ids[i] = self._adapters.slot_of(r.adapter)
        planes = self._adapters.arena_planes()
        planes["ids"] = self._dev(ids)
        self._adapters.count_gather()
        self._lora_dispatches += 1
        return planes

    def _count_sample_route(self, reqs_tokens):
        """Classify emitted tokens into the sample route counters;
        ``reqs_tokens`` is (request, n_emitted) pairs."""
        for r, k in reqs_tokens:
            sp = r.sampling
            if sp is None or sp.is_greedy:
                self._m.sample_greedy_tokens.inc(k)
            else:
                self._m.sample_sampled_tokens.inc(k)
            if sp is not None and sp.mask_processor is not None:
                self._m.sample_masked_tokens.inc(k)

    def _mask_dead_end(self, req: Request) -> bool:
        """Advance the request's token-mask state machine past its last
        emitted token and report whether the grammar completed (no legal
        continuation: the EOS of a constrained stream).  Called for live
        mask requests only, at the chunk-final and decode-block sites."""
        mp = req.sampling.mask_processor
        mp.advance(int(req.tokens[-1]))
        return not np.asarray(mp.allowed(), bool).any()

    def _block_rides(self, i: int, r: Request) -> bool:
        """Does slot ``i`` ride THIS iteration's plain decode block?
        Plain-decode rows always do; a spec-mode row only on an
        iteration where the whole spec mix drafted nothing
        (``_spec_fallback``): a zero-draft verify would pay the K+1-wide
        forward for one token."""
        return r.state == "decode" and (r.spec_k is None
                                        or i in self._spec_fallback)

    def _decode_tables(self) -> np.ndarray:
        """The decode block's table view: real rows for slots riding the
        block, all-trash rows for vacant, prefilling and verifying spec
        slots (a frozen row's write at its pinned ``lens`` must never
        land in a block another sequence owns, and a verifying row's
        blocks belong to the verify forward)."""
        tbl = np.full_like(self._tables, self._pool.trash)
        for i, r in enumerate(self._slots):
            if r is not None and self._block_rides(i, r):
                tbl[i] = self._tables[i]
        return tbl

    def _verify_fn(self, width: int, flags=NO_FLAGS, lora_on: bool = False):
        key = (width, flags, bool(lora_on))
        fn = self._verify_fns.get(key)
        if fn is None:
            fn = build_spec_verify(
                self._model, self.cfg, width,
                kv_int8=self.kv_cache_dtype == "int8", samp_flags=flags,
                lora=lora_on, wq=self._wq_ctx)
            self._verify_fns[key] = fn
        return fn

    def _spec_verify(self, out: List[Request]):
        """One speculative iteration over every spec-mode decode slot:
        draft (host), verify (ONE batched forward of width
        ``max(spec_decode) + 1`` over the engine's lifetime, narrower
        rows masked by ``n_valid``), accept (host), then advance each
        row's ``lens`` by exactly its emitted count: rejected draft
        positions stay behind the ``lens`` mask until the next forward
        overwrites them.  An iteration where no spec slot drafted
        anything sends the spec slots to the plain block instead."""
        spec = [i for i, r in enumerate(self._slots)
                if r is not None and r.state == "decode"
                and r.spec_k is not None]
        if not spec:
            return
        # defensive: spec entry goes through a chunk_final or resume
        # sync, so nothing is pending here; the verify reads host lens
        # mirrors, so a stale one must sync loudly rather than drift
        self._flush_async("spec", out)
        drafts = {}
        for i in spec:
            req = self._slots[i]
            # budget clamp: a verify emits <= k_eff + 1 tokens and its
            # last WRITE lands at lens + k_eff <= seq_len + max_new - 2,
            # never past the request's allocated blocks
            k_eff = min(req.spec_k, req.remaining - 1)
            d = self._drafter.propose(
                np.concatenate([req.prompt[:req.seq_len],
                                np.asarray(req.tokens, np.int32)]),
                k_eff) if k_eff > 0 else np.zeros((0,), np.int32)
            d = np.asarray(d).reshape(-1).astype(np.int32)[:k_eff]
            if k_eff > 0:
                # hit/miss score the drafter; budget-clamped tails
                # (k_eff == 0) never consulted it and count as neither
                if d.size:
                    self._m.spec_draft_hits.inc()
                else:
                    self._m.spec_draft_misses.inc()
                self._m.spec_draft_tokens.inc(int(d.size))
            drafts[i] = d
        if not any(drafts[i].size for i in spec):
            self._spec_fallback = set(spec)
            return
        width = self._spec_k_max + 1
        toks = np.full((self.num_slots, width), self.cfg.pad_token_id,
                       np.int32)
        n_valid = np.zeros((self.num_slots,), np.int32)
        tbl = np.full_like(self._tables, self._pool.trash)
        for i in spec:
            req = self._slots[i]
            d = drafts[i]
            toks[i, 0] = req.tokens[-1]   # the still-unfed last token
            toks[i, 1:1 + d.size] = d
            n_valid[i] = 1 + d.size
            tbl[i] = self._tables[i]
        spec_set = set(spec)
        riding = [r if i in spec_set else None
                  for i, r in enumerate(self._slots)]
        flags, planes = self._build_samp(riding)
        lora = self._build_lora(riding)
        lora_args = () if lora is None else (lora,)
        t0 = self._clock()
        with _span("serving.spec_verify", width=width, active=len(spec)):
            outp = self._verify_fn(width, flags, lora is not None)(
                self._dev(toks), self._dev(self._lens), self._dev(n_valid),
                self._dev(tbl), self._samp_tensors(planes), *lora_args,
                *self._arenas)
            if flags[0]:
                # a sampled mix: the position-keyed draws too ([B,
                # width] each)
                greedy, u, accept_p, resample, sample = self._fetch(
                    outp[:5])
            else:
                greedy = self._fetch(outp[:1])[0]       # [B, width]
        dt = self._clock() - t0
        self._verify_seconds += dt
        self._disp_s += dt
        self._m.spec_verifies.inc()
        # the K-wide kernel walks the STATIC width's frontier
        # (lens + width - 1) of every spec row, however few columns
        # n_valid marks valid
        self._count_kv_sweep([int(self._lens[i]) + width - 1 for i in spec])
        self._count_weight_sweep(1)
        if greedy.size and (int(greedy.min()) < 0
                            or int(greedy.max()) >= self._vocab):
            raise PoisonedDispatchError(
                f"verify forward at step {self._step_idx} produced token "
                f"ids outside [0, {self._vocab})")
        t = self._clock()
        gp: dict = {}          # tenant -> [useful, spec_reject, pad]
        for i in spec:
            req = self._slots[i]
            sp = req.sampling
            if sp is not None and not sp.is_greedy:
                emitted, accepted, resamples = accept_drafts_sampled(
                    drafts[i], u[i], accept_p[i], resample[i], sample[i],
                    self.cfg.eos_token_id)
                self._m.sample_resamples.inc(resamples)
            else:
                emitted, accepted = accept_drafts(greedy[i], drafts[i],
                                                  self.cfg.eos_token_id)
            self._m.spec_accepted_len.observe(float(accepted))
            self._m.spec_accepted_tokens.inc(accepted)
            self._m.tokens_emitted.inc(len(emitted))
            self._count_sample_route([(req, len(emitted))])
            # goodput: this row dispatched ``width`` positions — emitted
            # tokens are useful, rejected/EOS-cut draft positions are
            # spec_reject, the masked tail past n_valid is pad
            n_val = int(n_valid[i])
            cell = gp.setdefault(req.tenant, [0, 0, 0])
            cell[0] += len(emitted)
            cell[1] += n_val - len(emitted)
            cell[2] += width - n_val
            req.tokens.extend(emitted)
            req.remaining -= len(emitted)
            self._lens[i] += len(emitted)
            self._tok[i] = emitted[-1]
            _span_instant("serving.spec.accept", request=req.request_id,
                          drafted=int(drafts[i].size), accepted=accepted)
            self._fr.emit("spec_verify", req.request_id, self._step_idx,
                          drafted=int(drafts[i].size), accepted=accepted,
                          rejected=n_val - len(emitted),
                          emitted=len(emitted))
            hit_eos = (self.cfg.eos_token_id is not None
                       and emitted[-1] == self.cfg.eos_token_id)
            if hit_eos or req.remaining == 0:
                self._slots[i] = None
                self._done[i] = True
                self._release_blocks(req)
                self._finish(req, t, out)
        for tenant, (u_, rej, pad) in gp.items():
            self._ledger(u_, tenant=tenant, spec_reject=rej, pad=pad)

    # -- dispatch-ahead pipeline (plan / harvest) --
    def _charge_overlap(self, dt: float):
        """Account time spent waiting on a PREVIOUS iteration's device
        outputs: observed into serving.step.overlap_seconds and carved
        out of this step's host seconds."""
        self._m.step_overlap.observe(dt)
        self._time["overlap"] += dt
        if self._in_step:
            self._overlap_s += dt

    def _block_sync_reason(self, n: int, active: List[int],
                           lag: int = 0) -> Optional[str]:
        """Why THIS decode dispatch's outputs cannot be deferred (None =
        deferrable).  A harvest may be deferred only when the next
        iteration's scheduling cannot depend on it: no speculative slot
        needs a host accept/rollback decision and no rider's token
        BUDGET can run out inside the dispatch (``lag`` corrects host
        truth for steps still in flight) and no host-built logit plane
        (mask bias, repetition-penalty presence) needs the emitted token
        before the next dispatch.  EOS depends on the depth: at
        depth 1 every EOS-configured iteration syncs (scheduling equal
        to lockstep's); at depth >= 2 the finish bitmap is read one
        harvest late instead.  The first matching reason is charged."""
        if not self.async_dispatch:
            return "off"              # lockstep arm: never charged
        if self.cfg.eos_token_id is not None and self.async_depth == 1:
            return "eos"
        for i in active:
            r = self._slots[i]
            if r is None or r.state != "decode":
                continue              # retired by a same-step harvest
            if r.remaining - lag <= n:
                return "budget"
            sp = r.sampling
            if sp is not None and sp.mask_processor is not None:
                return "mask"
            if sp is not None and sp.needs_penalty:
                return "penalty"
            if r.spec_k is not None:
                return "spec"
        # a verifying spec slot anywhere keeps the iteration sync: the
        # verify path reads host mirrors
        if any(r is not None and r.spec_k is not None
               and r.state == "decode" for r in self._slots):
            return "spec"
        return None

    def _harvest_next(self, out: List[Request]):
        """Bring the OLDEST pending dispatch's outputs to the host and
        absorb them: the finish-bitmap poll site.  Harvests are FIFO, so
        host truth is fresh up to the popped dispatch.  The wait charges
        to overlap, never to host time."""
        if not self._pend_q:
            return
        p = self._pend_q.popleft()
        self._m.async_depth.set(len(self._pend_q))
        t0 = self._clock()
        toks, tok, lens, done = self._block_host(p)
        self._charge_overlap(self._clock() - t0)
        toks = self._checked_harvest(toks)
        n_before = len(out)
        self._absorb_block(p, toks, tok, lens, done, out)
        if self.async_depth == 1 and len(out) > n_before:
            # at depth 1 deferral is legal only when no rider can finish
            # inside the block: a finish here means the defer predicate
            # regressed
            raise RuntimeError(
                "deferred harvest produced a finish at async_depth=1 "
                "— the defer predicate (_block_sync_reason) is broken")
        self._reconcile_host_tier()

    def _flush_async(self, reason: str,
                     out: Optional[List[Request]] = None):
        """Harvest EVERY pending dispatch early (oldest first) because
        host truth is required now; charged ONCE to ``reason`` however
        deep the pipeline ran, and not at all when nothing is pending.
        Finishes it discovers (depth >= 2) land in ``out`` inside a step,
        else in the next step()'s return."""
        if not self._pend_q:
            return
        if reason not in ASYNC_SYNC_REASONS:
            raise ValueError(
                f"unknown forced-sync reason {reason!r} — known: "
                f"{ASYNC_SYNC_REASONS}")
        self._m.async_syncs.inc(reason=reason)
        sink = out if out is not None else self._flush_finishes
        while self._pend_q:
            self._harvest_next(sink)

    def _checked_harvest(self, toks: np.ndarray) -> np.ndarray:
        """Validate one decode harvest before it becomes host truth:
        every token id must lie in the vocabulary (vacant and frozen
        rows emit the pad id, which does); otherwise the dispatch is
        poisoned and :class:`PoisonedDispatchError` leaves every token
        stream untouched.  The fault injector's ``poison_at_step``
        corrupts the harvest's host copy right here (``toks`` is the
        host's own copy of the pinned outputs, never a device buffer
        or a graph's static output), upstream of the same validation a
        real device fault would hit."""
        if self._fault is not None and \
                self._fault.take_poison(self._step_idx):
            toks = np.full_like(toks, -1)
        if toks.size and (int(toks.min()) < 0
                          or int(toks.max()) >= self._vocab):
            raise PoisonedDispatchError(
                f"decode harvest at step {self._step_idx} produced token "
                f"ids outside [0, {self._vocab}) — poisoned dispatch; "
                f"the harvest was NOT adopted as host truth")
        return toks

    def step(self, now: Optional[float] = None) -> List[Request]:
        """One scheduler iteration: sweep queue-delay timeouts, admit and
        resume into vacant slots (preempting strictly-worse victims under
        block pressure), run at most one prefill chunk, then one
        speculative verify forward over the spec-mode slots and one
        decode block over the plain decode mix.  Returns the requests
        that reached a terminal state this iteration (finished or
        timeout).

        Also splits the iteration's wall time: every dispatch site
        (chunk, verify, decode block, swap gathers and scatters) adds to
        ``dispatch_seconds``, waits on a PREVIOUS iteration's outputs to
        ``overlap_seconds``, and the remainder is ``host_seconds``, the
        host-scheduler slice the pipeline hides under device time.
        Steps that dispatched nothing add to neither host nor
        dispatch."""
        self._step_idx += 1
        self._disp_s = 0.0
        self._overlap_s = 0.0
        self._stall_s = 0.0
        self._in_step = True
        t0 = self._clock()
        try:
            out = self._step_inner(now)
            # reconcile the demote gathers this step enqueued so their
            # wait lands here
            self._reconcile_host_tier()
        finally:
            self._in_step = False
        disp = self._disp_s
        if disp > 0.0:
            host = max((self._clock() - t0) - disp - self._overlap_s
                       - self._stall_s, 0.0)
            self._m.step_dispatch.observe(disp)
            self._m.step_host.observe(host)
            self._time["dispatch"] += disp
            self._time["host"] += host
        return out

    def _inject_faults(self, finished: List[Request]):
        """The fault injector's step-top hook, before any scheduling
        work: replica-fatal faults raise first (a killed or wedged
        replica did not run this step), then an injected stall sleeps
        (charged to serving.fault.stall_seconds and carved out of the
        step's host seconds), forced swaps preempt their requests and
        forced tier evictions drop cache parcels."""
        if self._fault.take_kill(self._step_idx):
            raise ReplicaKilledError(
                f"injected replica kill at step {self._step_idx} "
                f"(latched until the injector's replica restart)")
        if self._fault.take_permanent_stall():
            raise EngineStalledError(
                f"injected permanent stall at step {self._step_idx}: the "
                f"dispatch will never return (latched until the "
                f"injector's replica restart)")
        stall = self._fault.take_stall()
        if stall:
            with _span("serving.fault.stall", seconds=stall):
                t0 = self._clock()
                time.sleep(stall)
                dt = self._clock() - t0
            self._stall_s += dt
            self._m.stall_seconds.observe(dt)
        for rid in self._fault.take_forced_swaps():
            for r in self._slots:
                if r is not None and r.request_id == rid \
                        and r.state in ("prefill", "decode"):
                    self._preempt(r, reason="forced", out=finished)
                    break
        n_evict = self._fault.take_tier_evicts()
        if n_evict:
            applied = 0
            for _ in range(n_evict):
                if not self._host_tier.evict_one():
                    break
                applied += 1
            self._fault.record_tier_evicts(applied)
            self._update_host_gauge()

    def _step_inner(self, now: Optional[float] = None) -> List[Request]:
        # finishes a between-steps flush discovered (cancel()) hand over
        # to THIS step's return
        finished: List[Request] = self._flush_finishes
        self._flush_finishes = []
        t_now = self._clock() if now is None else now
        # step-rate estimate for the arrival-aware fused window, from
        # explicit step(now=) clocks only: a wall-clock-driven engine
        # never sizes windows from its own nondeterministic rate
        if now is not None:
            if self._last_now is not None and t_now > self._last_now:
                self._step_dt = t_now - self._last_now
            self._last_now = t_now
        else:
            self._step_dt = 0.0
            self._last_now = None
        if self._fault is not None:
            self._inject_faults(finished)
        self._admit(t_now, finished)
        self._prefill_chunk(finished)
        self._spec_fallback = set()
        self._spec_verify(finished)
        # re-assert spec rows' block state for THIS iteration: fallback
        # rows thaw into the block, verifying rows stay frozen, and a
        # thawing row's fed token comes from host truth (a frozen row's
        # block carry may hold pad or a garbage argmax)
        for i, r in enumerate(self._slots):
            if r is not None and r.state == "decode" \
                    and r.spec_k is not None:
                self._done[i] = i not in self._spec_fallback
                if i in self._spec_fallback:
                    self._tok[i] = r.tokens[-1]
        active = [i for i, r in enumerate(self._slots)
                  if r is not None and self._block_rides(i, r)]
        if not active:
            if self._pend_q:
                # the pipeline ran DRY because every rider finished
                # inside an in-flight dispatch (EOS seen on the device):
                # flush the ghost tail so the finishes retire
                self._flush_async("eos", finished)
            self._set_occupancy()
            return finished
        pend = self._pend_q[-1] if self._pend_q else None
        if pend is not None:
            # new decode entrants sync (chunk_final, resume), cancel and
            # preempt flush: a drift means the invariant broke.  At depth
            # 1 the set must match exactly; at depth >= 2 riders may
            # only LEAVE a deferred set (by finishing on the device)
            if self.async_depth == 1:
                if pend.active != active:
                    raise RuntimeError(
                        f"dispatch-ahead riding set drifted while a "
                        f"harvest was deferred: pending {pend.active} vs "
                        f"now {active}")
            elif not set(active) <= set(pend.active):
                raise RuntimeError(
                    f"dispatch-ahead riding set grew while a harvest was "
                    f"deferred: pending {pend.active} vs now {active}")
        # stale-truth correction: every rider's host truth is behind by
        # exactly the steps still in flight
        lag = sum(p.n for p in self._pend_q)
        # a full block only when no active request can finish inside it
        # (a block never overshoots a budget); otherwise single steps
        min_budget = min(self._slots[i].remaining for i in active) - lag
        # a mask row's host state machine must see every token: single
        # steps
        masked = any(self._slots[i].sampling is not None and
                     self._slots[i].sampling.mask_processor is not None
                     for i in active)
        n = 1 if (min_budget < self.steps_per_call or masked) \
            else self.steps_per_call
        # fused window (depth >= 2): when the next S iterations are
        # provably eventless (nothing queued or swapped to admit, no
        # chunk, a deferrable dispatch, budget headroom beyond the whole
        # window) dispatch them as ONE program of S x n steps
        iters = 1
        fuse_cap = self.async_depth
        if self._queue:
            # a queued request blocks fusing, unless every queued entry
            # is a known FUTURE arrival on an explicit step(now=) clock:
            # then the window shrinks to close at the arrival step
            fuse_cap = 0
            if self._step_dt > 0 and \
                    all(r.arrival_time > t_now for r in self._queue):
                nxt = min(r.arrival_time for r in self._queue)
                until = int(-(-(nxt - t_now) // self._step_dt))
                fuse_cap = min(self.async_depth, until)
        if (self.async_depth > 1 and not masked and not self._prefilling
                and not self._swapped and fuse_cap > 1
                and min_budget > self.async_depth * n
                and self._block_sync_reason(n, active, lag) is None):
            iters = fuse_cap
        n_total = n * iters
        active_set = set(active)
        riding = [self._slots[i] if i in active_set else None
                  for i in range(self.num_slots)]
        flags, planes = self._build_samp(riding, pos_lag=lag)
        # adapter ids are host-plan state, pinned with the riding set
        # (which cannot grow while a harvest is deferred): the
        # dispatch-ahead pipeline carries them with no sync of its own
        lora = self._build_lora(riding)
        pre_lens = np.array(self._lens)
        tables = self._dev(self._decode_tables())
        if pend is not None:
            # every current rider rode every pending dispatch, so its
            # true pre-dispatch lens is the mirror plus the steps in
            # flight; the carries feed straight in, device to device
            pre_lens[active] += lag
            carries = pend.out[1:5]
        else:
            budget = np.zeros((self.num_slots,), np.int32)
            for i in active:
                budget[i] = self._slots[i].remaining
            carries = (self._dev(self._tok), self._dev(self._lens),
                       self._dev(self._done), self._dev(budget))
        t_blk = self._clock()
        with _span("serving.decode_block", steps=n_total,
                   active=len(active)):
            prog = self._block_program(n_total, flags, lora is not None)
            samp = self._samp_tensors(planes, getattr(prog, "samp", None))
            out = prog(*carries, tables, samp,
                       ids=None if lora is None else lora["ids"])
            host, event, slot = self._stage_block(out)
        dt = self._clock() - t_blk
        self._disp_s += dt
        self._decode_seconds += dt
        # plan-known accounting lands at DISPATCH (the lockstep step);
        # token streams, the KV sweep, the ledger and the flight
        # recorder's events land at harvest
        self._m.decode_steps.inc(n_total)
        self._m.busy_slot_steps.inc(n_total * len(active))
        self._m.block_dispatches.inc()
        self._m.tokens_emitted.inc(n_total * len(active))
        self._count_sample_route(
            [(self._slots[i], n_total) for i in active])
        new_pend = _PendingBlock(
            step_idx=self._step_idx, n=n_total, per_iter=n, iters=iters,
            active=list(active), reqs=[self._slots[i] for i in active],
            pre_lens=pre_lens, out=tuple(out), host=host, event=event,
            slot=slot)
        self._pend_q.append(new_pend)
        # THE overlap point: older dispatches are harvested only now,
        # after this iteration's dispatch was enqueued
        while len(self._pend_q) > self.async_depth:
            self._harvest_next(finished)
            self._m.async_harvests.inc()
        reason = self._block_sync_reason(
            n_total, active, lag=sum(p.n for p in self._pend_q) - n_total)
        if reason is None:
            # steady-state pipeline depth (a sync iteration never counts
            # as depth)
            self._m.async_depth.set(len(self._pend_q))
        else:
            if self.async_dispatch:
                self._m.async_syncs.inc(reason=reason)
            # older dispatches flush first, FIFO (their waits charge to
            # overlap: they ran under later host work) ...
            while len(self._pend_q) > 1:
                self._harvest_next(finished)
            self._pend_q.pop()
            self._m.async_depth.set(0)
            t_mat = self._clock()
            toks, tok, lens, done = self._block_host(new_pend)
            # ... and the new dispatch's own wait is part of the
            # dispatch, the lockstep engine's attribution
            dt = self._clock() - t_mat
            self._disp_s += dt
            self._decode_seconds += dt
            toks = self._checked_harvest(toks)
            self._absorb_block(new_pend, toks, tok, lens, done, finished)
        return finished

    def _absorb_block(self, p: _PendingBlock, toks, tok, lens, done,
                      out: List[Request]):
        """The harvest half of one decode dispatch: adopt the host copies
        of its carries as host truth, extend each rider's token stream,
        charge its per-step KV sweep (scanned step s attends up to
        ``pre_lens + s``, clamped to the row's final ``lens`` where an
        EOS froze it) and retire riders whose finish bit flipped.  Shared
        by the sync path and the deferred one.  A fused dispatch is
        re-split here, iteration by iteration, so token streams and the
        sweep equal the unfused engine's; riders that finished in an
        EARLIER pending dispatch or an earlier iteration of this one were
        frozen on the device and are skipped."""
        per, active = p.per_iter, p.active
        self._tok = tok
        self._lens = lens
        eos = self.cfg.eos_token_id
        t = self._clock()
        lag = self._step_idx - p.step_idx
        sweep: List[int] = []
        for j in range(p.iters):
            gp: dict = {}      # tenant -> [useful, pad] this iteration
            for idx, i in enumerate(active):
                req = p.reqs[idx]
                if req.state != "decode":
                    continue           # ghost / finished-earlier rider
                row = toks[i, j * per:(j + 1) * per]
                base = int(p.pre_lens[i]) + j * per
                sweep.extend(min(base + s, int(lens[i]))
                             for s in range(per))
                # tokens up to (and including) an EOS are useful, the
                # frozen tail behind it is pad (empty at per == 1)
                hit_eos = eos is not None and eos in row
                useful_i = (int(np.flatnonzero(row == eos)[0]) + 1
                            if hit_eos else per)
                cell = gp.setdefault(req.tenant, [0, 0])
                cell[0] += useful_i
                cell[1] += per - useful_i
                attrs = {"steps": per}
                if lag:
                    # a step delta, never wall: parity comparisons
                    # against a sync engine strip it
                    attrs["lag"] = lag
                self._fr.emit("decode_block", req.request_id, p.step_idx,
                              **attrs)
                req.tokens.extend(int(x) for x in row)
                req.remaining -= per
                if hit_eos or req.remaining == 0 \
                        or (req.sampling is not None
                            and req.sampling.mask_processor is not None
                            and self._mask_dead_end(req)):
                    # the finish bitmap seen on the host (EOS in this
                    # iteration's segment, the budget ran out), or a mask
                    # row's grammar completed (per == 1 for mask rows)
                    self._slots[i] = None
                    done[i] = True     # freeze the row until re-use
                    self._release_blocks(req)
                    self._finish(req, t, out, lag=lag)
            for tenant, (u, pad) in gp.items():
                self._ledger(u, tenant=tenant, pad=pad)
        self._count_kv_sweep(sweep)
        # every scanned decode step streamed the whole weight set once
        self._count_weight_sweep(per * p.iters)
        self._done = done
        self._set_occupancy()

    def _stall_diagnosis(self, wall_timeout_s: float) -> str:
        """The state dump an ``EngineStalledError`` carries: enough to
        tell an exhausted pool from an injected fault from a trace whose
        arrivals lie beyond the wall budget."""
        active = {r.request_id: r.state for r in self._slots
                  if r is not None}
        now = self._clock()
        return (
            f"serving loop exceeded wall_timeout_s={wall_timeout_s} "
            f"without draining: queued={len(self._queue)} "
            f"(arrived={sum(r.arrival_time <= now for r in self._queue)}), "
            f"swapped={len(self._swapped)}, active slots={active}, "
            f"prefilling={len(self._prefilling)}, blocks free="
            f"{self._pool.available()} in_use={self._pool.in_use()} "
            f"cached={self._pool.cached()} of {self.num_blocks}, "
            f"fault_injector="
            f"{'armed' if self._fault is not None else 'none'}")

    def run(self, max_iters: Optional[int] = None,
            wall_timeout_s: Optional[float] = None) -> List[Request]:
        """Drain the queue and the swap list: admit/resume/prefill/
        decode until every submitted request is terminal.  Sleeps only
        when idle ahead of a future arrival, or (1 ms) after a step that
        ran and retired nothing with no slot occupied (a wedged pool or
        an injected fault).  ``wall_timeout_s`` bounds the whole drain
        in wall time: a wedged engine raises a diagnosable
        ``EngineStalledError`` (queue, slot and pool state in the
        message) after flushing the pipeline, and a later ``run()``
        continues where it stopped; ``max_iters`` bounds the steps
        (``RuntimeError``).  Returns this call's terminal requests
        (finished and timed out) in submission order, with the pipeline
        flushed."""
        finished: List[Request] = []
        iters = 0
        start = self._clock()
        while self._queue or self._swapped \
                or any(r is not None for r in self._slots):
            now = self._clock()
            if wall_timeout_s is not None and \
                    now - start > wall_timeout_s:
                # flush before raising: every token the device produced
                # reaches its request and the deferred ledger and
                # flight-recorder events land
                self._flush_async("drain")
                self._reconcile_host_tier()
                raise EngineStalledError(
                    self._stall_diagnosis(wall_timeout_s))
            if (not any(r is not None for r in self._slots)
                    and not self._swapped and self._queue):
                next_arrival = min(r.arrival_time for r in self._queue)
                if next_arrival > now:
                    time.sleep(min(0.005, next_arrival - now))
                    continue
            n_before = len(finished)
            finished.extend(self.step(now))
            if len(finished) == n_before and \
                    not any(r is not None for r in self._slots):
                # the step ran nothing and retired nothing: nap instead
                # of hot-spinning until wall_timeout_s or the fault
                # clears (any real progress occupies a slot)
                time.sleep(0.001)
            iters += 1
            if max_iters is not None and iters > max_iters:
                # flush before raising: every token the device produced
                # reaches its request, and the engine stays consistent
                self._flush_async("drain")
                self._reconcile_host_tier()
                raise RuntimeError(
                    f"serving loop exceeded max_iters={max_iters} with "
                    f"{len(self._queue)} queued / "
                    f"{len(self._swapped)} swapped / "
                    f"{sum(r is not None for r in self._slots)} active")
        # at depth 1 a drained loop leaves nothing pending (the last
        # rider's final block is a budget or eos sync); at depth >= 2
        # ghost dispatches after an in-flight EOS can remain
        self._flush_async("drain", finished)
        self._reconcile_host_tier()
        finished.extend(self._flush_finishes)
        self._flush_finishes = []
        return sorted(finished, key=lambda r: r.request_id)

    def stats(self) -> dict:
        """Scheduler counters.  ``mean_slot_occupancy`` is the fraction
        of (decode step x slot) cells that held a live request;
        ``prefix_hit_rate`` is block-granular over matchable prompt
        blocks; ``peak_blocks_in_use`` is the pool's refcount>0
        high-water mark; ``decode_seconds`` and ``verify_seconds`` are
        host wall time spent dispatching decode blocks and verify
        forwards, with the wait of a harvest that syncs at once (a
        deferred harvest's wait is ``overlap_seconds``);
        ``weight_bytes_swept`` and ``kv_bytes_swept`` are the modeled
        weight and KV streams (every prefill chunk, decode
        step and verify forward reads the whole weight set once).  The
        ``spec_*`` keys cover speculative decoding:
        ``spec_acceptance_rate`` is accepted over drafted tokens and
        ``spec_mean_accepted_len`` accepted draft tokens per verify
        forward, summed over its spec slots.  The overload keys:
        ``preemptions``/``preempt_resumes`` count swap-outs and
        re-admissions, ``swap_blocks_out/in`` and ``swap_bytes_out/in``
        the block traffic through the host-RAM tier (preemption and
        radix demotion/promotion together), ``swap_host_blocks``/
        ``swapped_waiting`` the preempt half's current footprint and
        ``host_cache_blocks`` the cache half's, ``shed``/``timeouts``/
        ``cancelled`` the requests dropped.  The tiered prefix cache's:
        ``prefix_hit_tokens`` (mapped blocks x block_len),
        ``prefix_partial_hits`` (admissions whose token-level match ran
        past the last mappable block), ``prefix_host_hits``/
        ``host_swapin_blocks`` (hits served by a host->device swap-in).
        ``sampled_tokens``/``greedy_tokens`` split emitted tokens by
        sampling route (``masked_tokens`` of them under an active token
        mask; counted at dispatch, as the reference does); and
        ``sample_resamples`` counts residual draws consumed by
        speculative sampling.  The dispatch-ahead keys: ``async_syncs`` and
        ``async_syncs_by_reason`` count forced early harvests by the
        closed ``ASYNC_SYNC_REASONS`` vocabulary, ``async_harvests`` the
        harvests that ran after the next dispatch was enqueued;
        ``dispatch_seconds``/``overlap_seconds``/``host_seconds`` split
        the steps' wall (``step()``); ``decode_graphs`` counts the
        decode block's CUDA graphs, their replays and the seconds their
        captures took (none on the CPU).  While a harvest is deferred
        the output-dependent counters (``kv_bytes_swept``, tokens) lag
        by at most the pipeline's depth; ``run()`` returns flushed.

        The counters are read back out of the metrics registry as
        per-engine deltas (``_ServingInstruments``: exact for engines
        used one after another on a shared registry; a disabled
        registry freezes them).  The goodput-ledger keys:
        ``useful_tokens`` + ``wasted_tokens`` == ``dispatched_tokens``
        exactly, ``goodput`` is the useful fraction and
        ``wasted_by_reason`` the breakdown over ``GOODPUT_REASONS``;
        ``handoffs``/``handoff_blocks``/``handoff_bytes`` count the
        chunk-final handoffs of a prefill-role engine (0 for ``"both"``
        and ``"decode"``); ``mean_tpot_s`` is the mean
        per-output-token decode latency over finished requests with
        >= 2 tokens (None while there is none); ``slo_attained``/
        ``slo_missed`` the SLO outcomes of requests that carried a
        deadline or a queue-delay bound.  The step split
        (``dispatch/overlap/host_seconds``) and ``decode_seconds``/
        ``verify_seconds`` are engine totals kept beside the
        histograms, so they advance with the registry disabled too.
        """
        m = self._m
        since = m.since_init
        graphs = [p for p in self._blocks.values()
                  if isinstance(p, DecodeBlockGraph)]
        steps = int(since(m.decode_steps))
        busy = int(since(m.busy_slot_steps))
        verifies = int(since(m.spec_verifies))
        drafted = int(since(m.spec_draft_tokens))
        accepted = int(since(m.spec_accepted_tokens))
        hits, misses = int(since(m.prefix_hits)), int(since(m.prefix_misses))
        ttfts = [r.ttft for r in self._finished if r.ttft is not None]
        lats = [r.latency for r in self._finished if r.latency is not None]
        tpots = [(r.finish_time - r.first_token_time) / (r.n_emitted - 1)
                 for r in self._finished
                 if r.state == "finished" and r.first_token_time is not None
                 and r.finish_time is not None and r.n_emitted > 1]
        useful = int(since(m.goodput_useful))
        wasted = int(since(m.goodput_wasted))
        dispatched = int(since(m.goodput_dispatched))
        syncs = {reason: int(m.syncs_since(reason))
                 for reason in ASYNC_SYNC_REASONS}
        return {
            "num_slots": self.num_slots,
            "kv_cache_dtype": self.kv_cache_dtype,
            "weight_dtype": self.weight_dtype,
            "kv_bytes_swept": int(since(m.kv_bytes_swept)),
            "weight_bytes_swept": int(since(m.weights_bytes_swept)),
            "finished": int(since(m.requests_finished)),
            "cancelled": int(since(m.requests_cancelled)),
            "prefills": int(since(m.prefills)),
            "prefill_chunks": int(since(m.prefill_chunks)),
            "decode_steps": steps,
            "busy_slot_steps": busy,
            "block_dispatches": int(since(m.block_dispatches)),
            "mean_slot_occupancy": (busy / (steps * self.num_slots)
                                    if steps else 0.0),
            "peak_queue": self._peak_queue,
            "block_len": self.block_len,
            "num_blocks": self.num_blocks,
            "blocks_in_use": self._pool.in_use(),
            "peak_blocks_in_use": self._peak_blocks,
            "prefix_cached_blocks": self._pool.cached(),
            "prefix_hits": hits,
            "prefix_misses": misses,
            "prefix_hit_rate": (hits / (hits + misses)
                                if hits + misses else 0.0),
            "prefix_hit_tokens": int(since(m.prefix_hit_tokens)),
            "prefix_partial_hits": int(since(m.prefix_partial_hits)),
            "prefix_host_hits": int(since(m.prefix_host_hits)),
            "host_swapin_blocks": int(since(m.prefix_host_swapin)),
            "mean_latency_s": (sum(lats) / len(lats)) if lats else None,
            "mean_ttft_s": (sum(ttfts) / len(ttfts)) if ttfts else None,
            "decode_seconds": self._decode_seconds,
            "verify_seconds": self._verify_seconds,
            "spec_verify_steps": verifies,
            "spec_draft_hits": int(since(m.spec_draft_hits)),
            "spec_draft_misses": int(since(m.spec_draft_misses)),
            "spec_draft_tokens": drafted,
            "spec_accepted_tokens": accepted,
            "spec_acceptance_rate": (accepted / drafted
                                     if drafted else 0.0),
            "spec_mean_accepted_len": (accepted / verifies
                                       if verifies else 0.0),
            "sampled_tokens": int(since(m.sample_sampled_tokens)),
            "greedy_tokens": int(since(m.sample_greedy_tokens)),
            "masked_tokens": int(since(m.sample_masked_tokens)),
            "sample_resamples": int(since(m.sample_resamples)),
            "preemptions": int(since(m.preempts)),
            "preempt_resumes": int(since(m.preempt_resumes)),
            "swap_blocks_out": int(since(m.swap_out_blocks)),
            "swap_blocks_in": int(since(m.swap_in_blocks)),
            "swap_bytes_out": int(since(m.swap_out_bytes)),
            "swap_bytes_in": int(since(m.swap_in_bytes)),
            "swap_host_blocks": self._host_tier.blocks("preempt"),
            "host_cache_blocks": self._host_tier.blocks("cache"),
            "swapped_waiting": len(self._swapped),
            "shed": int(since(m.shed)),
            "timeouts": int(since(m.timeouts)),
            "useful_tokens": useful,
            "wasted_tokens": wasted,
            "dispatched_tokens": dispatched,
            "goodput": (useful / dispatched if dispatched else 0.0),
            "wasted_by_reason": dict(self._wasted_reason),
            "handoffs": int(since(m.handoff_requests)),
            "handoff_blocks": int(since(m.handoff_blocks)),
            "handoff_bytes": int(since(m.handoff_bytes)),
            "role": self.role,
            "mean_tpot_s": (sum(tpots) / len(tpots)) if tpots else None,
            "slo_attained": int(since(m.slo_attained)),
            "slo_missed": int(since(m.slo_missed)),
            # fair share and batched LoRA: the per-tenant service ledger
            # the round-robin orders by, the admissions where fairness
            # overrode the plain order, and the gathered-product
            # dispatch count (the LoRA-versus-base route split)
            "tenant_served_tokens": dict(self._tenant_served),
            "fair_reorders": int(since(m.fairshare_reorders)),
            "lora_dispatches": self._lora_dispatches,
            "adapters_resident": (
                None if self._adapters is None else sum(
                    1 for name in self._adapters.names()
                    if self._adapters.resident(name))),
            "async_dispatch": self.async_dispatch,
            "async_depth": self.async_depth,
            "async_syncs": int(since(m.async_syncs)),
            "async_harvests": int(since(m.async_harvests)),
            "async_syncs_by_reason": syncs,
            "dispatch_seconds": self._time["dispatch"],
            "overlap_seconds": self._time["overlap"],
            "host_seconds": self._time["host"],
            "decode_graphs": {
                "captures": len(graphs),
                "replays": sum(g.replays for g in graphs),
                "capture_seconds": self._graph_capture_s},
        }

    @property
    def metrics_registry(self):
        """The MetricsRegistry this engine records into (the process
        default unless one was passed at construction)."""
        return self._m.registry

    @property
    def flight_recorder(self) -> FlightRecorder:
        """The per-request flight recorder (a disabled default unless
        one was passed at construction — ``.enable()`` flips it
        live)."""
        return self._fr

    def explain(self, request_id: int) -> str:
        """Human-readable lifecycle of one request, from the flight
        recorder ("waited 3 steps behind req 7, preempted at step 12,
        resumed via 6 host blocks ...")."""
        return self._fr.explain(request_id)

    def load_report(self) -> dict:
        """One host-side load and residency snapshot for schedulers above
        the engine (the router's load signal and affinity probes), as
        plain Python values (the wire's frames carry it).  Pure host
        state: no dispatch, no harvest flush, so polling it every
        routing decision is free.  ``queue_depth``/``active_slots``/
        ``prefilling``/``swapped_waiting`` count outstanding work by
        phase; ``slots_total``/``blocks_free`` (free plus reclaimable
        cached, the pool's ``available()``)/``blocks_in_use``/
        ``blocks_total``/``block_len`` the headroom; ``hbm_adapters`` the
        adapter names resident in the store's arenas (``[]`` without a
        store), the adapter-affinity signal; ``radix`` the prefix tree's root
        stats (None off radix mode); ``kv_cache_dtype``/``weight_dtype``
        the at-rest dtypes; ``shard_group`` None (one device); ``role``
        the disaggregation role."""
        return {
            "queue_depth": len(self._queue),
            "active_slots": sum(r is not None for r in self._slots),
            "prefilling": len(self._prefilling),
            "swapped_waiting": len(self._swapped),
            "slots_total": self.num_slots,
            "blocks_free": self._pool.available(),
            "blocks_in_use": self._pool.in_use(),
            "blocks_total": self.num_blocks,
            "block_len": self.block_len,
            "hbm_adapters": (self._adapters.hbm_resident()
                             if self._adapters is not None else []),
            "radix": (self._radix.root_stats()
                      if self._radix is not None else None),
            "kv_cache_dtype": self.kv_cache_dtype,
            "weight_dtype": self.weight_dtype,
            "shard_group": self.shard_group,
            "role": self.role,
        }

    def engine_spec(self) -> dict:
        """The engine's immutable identity as one JSON-safe dict, key
        for key the JAX engine's ``engine_spec()``; ``adapters`` lists the
        registered adapter names (None without a store: "no store" and
        "empty store" route differently)."""
        return {
            "prompt_len": self.prompt_len,
            "max_cache_len": self.max_cache_len,
            "block_len": self.block_len,
            "num_blocks": self.num_blocks,
            "num_slots": self.num_slots,
            "chunk_len": self.chunk_len,
            "kv_cache_dtype": self.kv_cache_dtype,
            "weight_dtype": self.weight_dtype,
            "pad_token_id": int(self.cfg.pad_token_id),
            "kv_row_bytes": int(self._kv_row_bytes),
            "adapters": (None if self._adapters is None
                         else list(self._adapters.names())),
            "shard_group": self.shard_group,
            "role": self.role,
        }
