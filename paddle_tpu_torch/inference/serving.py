"""Continuous-batching serving over a paged KV block pool: port of the
synchronous, greedy core of ``paddle_tpu/inference/serving.py``, with a
float or int8 KV cache (``kv_cache_dtype="int8"``), float or int8/int4
weights (``weight_dtype=``) and greedy speculative decoding
(``submit(spec_decode=K)`` with an ``NGramDrafter`` or ``ModelDrafter``),
in any combination.

Ported: ``_block_digests`` (:829), ``BlockPool`` (:859, the digest half),
``Request`` (:1181) and ``ServingEngine`` (:1341) with ``submit``,
``_admit`` (no preemption, no swap), ``_prefill_chunk`` (digest
registration included), ``_count_kv_sweep`` (:1813), ``_block_rides``
and ``_decode_tables`` (:4106-4131), ``_spec_verify`` (:4146, greedy
rows), the synchronous branch of ``_step_inner``, ``_absorb_block``,
``_finish``, ``_release_blocks``, ``run``, ``engine_spec`` and ``stats``
(a subset of keys, kept in plain integer counters instead of the metrics
registry).

Scheduling is the JAX engine's: requests are admitted priority-then-EDF
(FIFO within a class) into vacant slots, and each step runs at most one
prefill chunk, then one speculative verify forward over the spec-mode
slots, then one decode block over the plain slots; the digest prefix
cache maps whole prompt blocks a finished chunk published.
On the same trace the port makes the same decisions (admissions,
dispatch counts, prefix hits) as the JAX engine with
``async_dispatch=False, prefix_cache_mode="digest",
enable_preemption=False``.

Features not ported yet take only their off values and raise
``NotImplementedError`` naming the ROADMAP.md item that brings them.
Known differences from the JAX engine: ``prefix_cache_mode`` defaults to
``"digest"`` (JAX: ``"radix"``), ``async_dispatch`` to ``False`` and
``enable_preemption`` to ``False``; there is no metrics registry, flight
recorder or span tracing.
"""

from __future__ import annotations

import hashlib
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..device import DeviceLike, dtype_name, resolve_device, to_dtype
from ..models.generation import GenerationConfig, init_paged_kv_arena
from .llm import (build_weight_quant_plan, chunk_prefill,
                  normalize_weight_dtype, paged_decode_block)
from .speculative import NGramDrafter, accept_drafts, build_spec_verify

_INF = float("inf")


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


class BlockPool:
    """Host-side allocator for the device block arena: a free list over
    ``num_blocks`` logical blocks plus a refcounted digest prefix cache.

    ``alloc`` hands a block out with refcount 1; ``pin``/``unpin`` move
    the refcount as prefix sharers map it in and requests retire; a
    block whose refcount drops to 0 returns to the free list UNLESS it
    is published in the digest map — then it parks in an LRU, still
    mapped, and is reclaimed (unmapped) only when the free list runs
    dry.  The arena's extra row ``trash`` is never allocated."""

    def __init__(self, num_blocks: int, block_len: int):
        self.num_blocks = int(num_blocks)
        self.block_len = int(block_len)
        self.trash = self.num_blocks           # extra arena row index
        self._free = list(range(self.num_blocks - 1, -1, -1))
        self._ref = [0] * self.num_blocks
        self._digest_of: List[Optional[bytes]] = [None] * self.num_blocks
        self._by_digest = {}                   # digest -> block id
        self._lru: OrderedDict = OrderedDict()  # digest -> block, ref == 0

    def available(self) -> int:
        """Blocks allocatable right now (free + reclaimable cached)."""
        return len(self._free) + len(self._lru)

    def in_use(self) -> int:
        """Blocks pinned by live or queued requests (refcount > 0)."""
        return self.num_blocks - self.available()

    def cached(self) -> int:
        """Unpinned blocks kept mapped for future prefix hits."""
        return len(self._lru)

    def lookup(self, digest: bytes) -> Optional[int]:
        return self._by_digest.get(digest)

    def pin(self, block: int):
        if self._ref[block] == 0:
            dg = self._digest_of[block]
            if dg is not None:
                self._lru.pop(dg, None)
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
            else:
                self._free.append(block)

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
        the pool cannot serve ``n``."""
        if n > self.available():
            return None
        out = []
        for _ in range(n):
            if self._free:
                b = self._free.pop()
            else:
                dg, b = self._lru.popitem(last=False)
                del self._by_digest[dg]
                self._digest_of[b] = None
            self._ref[b] = 1
            out.append(b)
        return out


@dataclass
class Request:
    """One serving request and its lifecycle accounting.

    ``tokens`` accumulates generated ids; after EOS the stream is
    ``pad_token_id``, and ``output`` is always exactly
    ``max_new_tokens`` long.  ``state`` walks queued -> prefill ->
    decode -> finished."""
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
    priority: int = 0                  # higher admits first
    deadline: Optional[float] = None   # absolute clock() time
    pf_pos: int = 0                    # next prompt position to compute
    matched: List[int] = field(default_factory=list)   # prefix-hit blocks
    blocks: List[int] = field(default_factory=list)    # full block map
    digests: List[bytes] = field(default_factory=list)
    registered: int = 0                # blocks published so far
    chunk_ids: Optional[np.ndarray] = None  # prompt padded to chunk grid
    spec_k: Optional[int] = None       # speculative mode: drafts/verify

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


class ServingEngine:
    """Continuous-batching serving session over a paged KV block pool.

    ``submit()`` enqueues requests (optionally with a future
    ``arrival_time`` for trace replay); ``step()`` runs one scheduler
    iteration (admit + at most one prefill chunk + one verify forward
    over the spec-mode slots + one decode block);
    ``run()`` drains everything and returns the finished requests.

    The engine runs on ``device`` (default: the CUDA card; ``"cpu"``
    for tests) and moves the model there, casting its float parameters
    to ``compute_dtype`` in place once — the JAX engine's once-per-call
    hoisted cast (``_cast_params``).  The KV arenas live on the device
    and are updated in place by every program.

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
                 registry=None, max_queue=None, enable_preemption=False,
                 fault_injector=None, flight_recorder=None,
                 async_dispatch=False, async_depth=1,
                 adapter_store=None, tenant_weights=None, mesh=None,
                 role="both", device: DeviceLike = None):
        for value, off, what, item in (
                (bool(do_sample), False, "do_sample=True",
                 "sampling and speculation"),
                (mesh, None, "mesh= (tensor-parallel serving)",
                 "sharded serving"),
                (str(role), "both", f"role={role!r} (disaggregation)",
                 "fleet layer"),
                (adapter_store, None, "adapter_store= (LoRA serving)",
                 "LoRA and fair share"),
                (tenant_weights, None, "tenant_weights= (fair share)",
                 "LoRA and fair share"),
                (host_cache_blocks, None,
                 "host_cache_blocks= (host-RAM block tier)",
                 "preemption, host swap and the radix tiers"),
                (bool(enable_preemption), False, "enable_preemption=True",
                 "preemption, host swap and the radix tiers"),
                (fault_injector, None, "fault_injector=", "fleet layer"),
                (max_queue, None, "max_queue= (bounded queue shedding)",
                 "preemption, host swap and the radix tiers"),
                (registry, None, "registry= (metrics registry)",
                 "observability"),
                (flight_recorder, None, "flight_recorder=",
                 "observability"),
                (bool(async_dispatch), False, "async_dispatch=True",
                 "dispatch-ahead"),
                (int(async_depth), 1, f"async_depth={async_depth}",
                 "dispatch-ahead")):
            if value != off:
                _not_ported(what, item)
        # an explicit prefix_cache_mode wins over the legacy bool, as in
        # the JAX engine; unset, it is "digest" (the JAX default, "radix",
        # is not ported yet)
        if prefix_cache_mode is None:
            mode = "digest" if enable_prefix_cache else "none"
        else:
            mode = str(prefix_cache_mode)
        if mode == "radix":
            _not_ported('prefix_cache_mode="radix"',
                        "preemption, host swap and the radix tiers")
        if mode not in ("digest", "none"):
            raise ValueError(
                f"prefix_cache_mode must be 'digest' or 'none' (or "
                f"'radix', not ported yet), got {prefix_cache_mode!r}")
        self.prefix_cache_mode = mode
        self.enable_prefix_cache = mode != "none"
        self.device = resolve_device(device)
        self.num_slots = int(num_slots)
        self.prompt_len = int(prompt_len)
        self.max_cache_len = int(max_cache_len or (prompt_len + 256))
        self.steps_per_call = int(steps_per_call)
        self.block_len = int(block_len)
        self.static_batching = bool(static_batching)
        self.role = "both"
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
                f"paged decode kernel takes one dtype")
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
        self._pool = BlockPool(self.num_blocks, self.block_len)
        self._digest_salt = ("ptpu-paged-kv/"
                             + self.kv_cache_dtype).encode()
        self._tables = np.full((self.num_slots, self.max_blocks),
                               self._pool.trash, np.int32)
        self._vocab = int(model.config.vocab_size)
        self._tok = np.zeros((self.num_slots,), np.int32)
        self._lens = np.zeros((self.num_slots,), np.int32)
        self._done = np.ones((self.num_slots,), bool)
        self._slots: List[Optional[Request]] = [None] * self.num_slots
        self._queue: deque = deque()
        self._prefilling: deque = deque()
        self._finished: List[Request] = []
        self._clock = clock
        self._next_id = 0
        self._step_idx = 0
        self._peak_queue = 0
        self._peak_blocks = 0
        # scheduler counters (the JAX engine keeps these in its metrics
        # registry; stats() reads them back)
        self._n = dict(finished=0, prefills=0, prefill_chunks=0,
                       decode_steps=0, busy_slot_steps=0,
                       block_dispatches=0, prefix_hits=0, prefix_misses=0,
                       kv_bytes_swept=0, spec_verify_steps=0,
                       spec_draft_hits=0, spec_draft_misses=0,
                       spec_draft_tokens=0, spec_accepted_tokens=0)
        self._decode_seconds = 0.0
        self._verify_seconds = 0.0
        # speculative decoding: per-request mode (submit(spec_decode=K));
        # the drafter is engine-level and installed lazily (an
        # NGramDrafter) the first time a spec request is accepted
        self._drafter = drafter
        self._spec_k_max = 0           # engine-lifetime max spec_decode
        self._spec_fallback = set()    # this iteration's spec slots that
        #                                drafted nothing and ride the block
        self._verify_fns = {}          # width -> verifier

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
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- block accounting --
    def _blocks_needed(self, n: int, m: int) -> int:
        """Blocks a request writes: prompt + generated K/V is n + m - 1
        slots (the last sampled token is emitted, never fed back)."""
        return -(-(n + m - 1) // self.block_len)

    def _update_block_gauges(self):
        self._peak_blocks = max(self._peak_blocks, self._pool.in_use())

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
        self._n["kv_bytes_swept"] += rows * self._kv_row_bytes

    def _release_blocks(self, req: Request):
        """Unpin every block the request holds and trash its table row.
        Idempotent: the block list is cleared before returning."""
        for b in req.blocks:
            self._pool.unpin(b)
        req.blocks = []
        req.matched = []
        if req.slot is not None:
            self._tables[req.slot] = self._pool.trash
        self._update_block_gauges()

    def submit(self, prompt_ids, seq_len=None, max_new_tokens=32,
               arrival_time=None, spec_decode=None, sampling=None,
               priority: int = 0, deadline_s: Optional[float] = None,
               max_queue_delay_s: Optional[float] = None,
               adapter: Optional[str] = None, tenant: Optional[str] = None,
               stream: bool = False) -> Request:
        """Enqueue one request.  ``prompt_ids`` is a 1-D id array of at
        most ``prompt_len`` tokens (right-padded internally);
        ``arrival_time`` (in ``clock()`` units) lets a trace replay
        future arrivals.  ``priority`` (higher admits first) and
        ``deadline_s`` (seconds from arrival; EDF within a priority)
        order admission.  With prefix caching on, the prompt's full
        blocks are probed against the cache here and any hits are
        PINNED so they cannot be reclaimed while the request waits."""
        for value, off, what, item in (
                (sampling, None, "submit(sampling=)",
                 "sampling and speculation"),
                (max_queue_delay_s, None, "submit(max_queue_delay_s=)",
                 "preemption, host swap and the radix tiers"),
                (adapter, None, "submit(adapter=)", "LoRA and fair share"),
                (tenant, None, "submit(tenant=)", "LoRA and fair share"),
                (bool(stream), False, "submit(stream=True)",
                 "fleet layer")):
            if value != off:
                _not_ported(what, item)
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
        spec_k = None
        if spec_decode is not None:
            spec_k = int(spec_decode)
            if spec_k < 1:
                raise ValueError(
                    f"spec_decode must be >= 1 draft tokens, got "
                    f"{spec_decode}")
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
        if deadline_s is not None and float(deadline_s) <= 0:
            raise ValueError(
                f"deadline_s must be > 0 seconds from arrival, got "
                f"{deadline_s}")
        padded = np.full((self.prompt_len,), self.cfg.pad_token_id,
                         np.int32)
        padded[:ids.size] = ids
        now = self._clock()
        arrival = now if arrival_time is None else float(arrival_time)
        req = Request(self._next_id, padded, n, m, arrival,
                      pad_token_id=self.cfg.pad_token_id)
        req.submit_time = now
        req.priority = int(priority)
        req.deadline = None if deadline_s is None \
            else arrival + float(deadline_s)
        req.spec_k = spec_k
        # chunk grid: any slice [start, start + chunk_len) with
        # start < seq_len must be in range
        req.chunk_ids = np.full((self.prompt_len + self.chunk_len,),
                                self.cfg.pad_token_id, np.int32)
        req.chunk_ids[:self.prompt_len] = padded
        if self.enable_prefix_cache:
            req.digests = _block_digests(padded, n, self.block_len,
                                         salt=self._digest_salt)
            # match at most (n-1)//block_len blocks: the block holding
            # the prompt's LAST token is always recomputed — sampling
            # the first output token needs its hidden state
            self._match_prefix(req)
        if spec_k is not None:
            # only after every validation: a rejected submit must not
            # widen the engine-lifetime verify width or install the
            # default drafter
            if self._drafter is None:
                self._drafter = NGramDrafter()
            self._spec_k_max = max(self._spec_k_max, spec_k)
        self._next_id += 1
        self._queue.append(req)
        self._peak_queue = max(self._peak_queue, len(self._queue))
        return req

    def _match_prefix(self, req: Request):
        """Extend ``req.matched`` with the published blocks of its next
        prompt digests (pinned), stopping at the first miss."""
        for dg in req.digests[len(req.matched):
                              (req.seq_len - 1) // self.block_len]:
            b = self._pool.lookup(dg)
            if b is None:
                break
            self._pool.pin(b)
            req.matched.append(b)
        if req.matched:
            self._update_block_gauges()

    def _finish(self, req: Request, t: float, out: List[Request]):
        req.finish_time = t
        req.state = "finished"
        req.slot = None
        self._n["finished"] += 1
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

    def _release_queue_pins(self):
        """Head-of-line valve: drop every queued request's submit-time
        prefix pins so a cold, full-width allocation can succeed."""
        for r in self._queue:
            for b in r.matched:
                self._pool.unpin(b)
            r.matched = []
        self._update_block_gauges()

    def _admit(self, now: float, out: List[Request]):
        """Admit the best-class arrived candidates into vacant slots.
        Admission is head-of-line: when the pool cannot serve the head
        candidate (even after the valve, with nothing running), nothing
        behind it is admitted until blocks retire.  ``static_batching``
        admits only into an EMPTY pool (the gang baseline)."""
        if self.static_batching and \
                any(r is not None for r in self._slots):
            return
        while True:
            slot = next((i for i, r in enumerate(self._slots)
                         if r is None), None)
            if slot is None:
                break
            cands = sorted((r for r in self._queue
                            if r.arrival_time <= now), key=self._sched_key)
            if not cands:
                break
            req = cands[0]
            if self.enable_prefix_cache:
                # blocks computed between submit and now may extend the
                # match (the prefix holder prefilled while this queued)
                self._match_prefix(req)
            n_hbm = len(req.matched)
            total = self._blocks_needed(req.seq_len, req.max_new_tokens)
            fresh = self._pool.alloc(total - n_hbm)
            if fresh is None and \
                    not any(r is not None for r in self._slots):
                self._release_queue_pins()
                n_hbm = 0
                fresh = self._pool.alloc(total)
            if fresh is None:
                break                     # pool drains as requests retire
            matchable = ((req.seq_len - 1) // self.block_len
                         if self.enable_prefix_cache else 0)
            mapped = req.matched
            req.blocks = req.matched + fresh
            self._queue.remove(req)
            self._n["prefix_hits"] += len(mapped)
            self._n["prefix_misses"] += matchable - len(mapped)
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
            self._update_block_gauges()

    def _prefill_chunk(self, out: List[Request]):
        """Run at most ONE prompt chunk (FIFO over admissions).  The
        final chunk samples the request's first token and moves it into
        the decode mix; completed full blocks are published to the
        prefix cache as soon as they are written."""
        if not self._prefilling:
            return
        req = self._prefilling[0]
        start, c = req.pf_pos, self.chunk_len
        outp = chunk_prefill(
            self._model, self._dev(req.chunk_ids[None, start:start + c]),
            start, req.seq_len, self._dev(self._tables[req.slot][None, :]),
            self._arenas, wq=self._wq_ctx)
        tok0 = int(outp[0][0])
        self._n["prefill_chunks"] += 1
        self._count_kv_sweep([min(start + c, req.seq_len) - 1])
        req.pf_pos = start + c
        if self.enable_prefix_cache:
            full = min(req.pf_pos, req.seq_len) // self.block_len
            while req.registered < min(full, len(req.digests)):
                i = req.registered
                self._pool.register(req.blocks[i], req.digests[i])
                req.registered = i + 1
        if req.pf_pos < req.seq_len:
            return                        # more chunks to go
        self._prefilling.popleft()
        self._n["prefills"] += 1
        t = self._clock()
        req.first_token_time = t
        req.tokens.append(tok0)
        req.remaining = req.max_new_tokens - 1
        slot = req.slot
        if (self.cfg.eos_token_id is not None and
                tok0 == self.cfg.eos_token_id) or req.remaining == 0:
            # finished at the first token: never enters the decode mix
            self._slots[slot] = None
            self._done[slot] = True
            self._release_blocks(req)
            self._finish(req, t, out)
            return
        req.state = "decode"
        self._tok[slot] = tok0
        self._lens[slot] = req.seq_len
        # spec-mode rows never ride the plain decode block: their row
        # stays done there (frozen lens, trash-routed writes) and all
        # progress happens in the verify forward, which reads host truth
        self._done[slot] = req.spec_k is not None

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

    def _verify_fn(self, width: int):
        fn = self._verify_fns.get(width)
        if fn is None:
            fn = build_spec_verify(
                self._model, self.cfg, width,
                kv_int8=self.kv_cache_dtype == "int8", wq=self._wq_ctx)
            self._verify_fns[width] = fn
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
                self._n["spec_draft_hits" if d.size
                        else "spec_draft_misses"] += 1
                self._n["spec_draft_tokens"] += int(d.size)
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
        t0 = self._clock()
        outp = self._verify_fn(width)(
            self._dev(toks), self._dev(self._lens), self._dev(n_valid),
            self._dev(tbl), *self._arenas)
        greedy = outp[0].cpu().numpy()                  # [B, width]
        self._verify_seconds += self._clock() - t0
        self._n["spec_verify_steps"] += 1
        # the K-wide kernel walks the STATIC width's frontier
        # (lens + width - 1) of every spec row, however few columns
        # n_valid marks valid
        self._count_kv_sweep([int(self._lens[i]) + width - 1 for i in spec])
        if greedy.size and (int(greedy.min()) < 0
                            or int(greedy.max()) >= self._vocab):
            raise RuntimeError(
                f"verify forward at step {self._step_idx} produced token "
                f"ids outside [0, {self._vocab})")
        t = self._clock()
        for i in spec:
            req = self._slots[i]
            emitted, accepted = accept_drafts(greedy[i], drafts[i],
                                              self.cfg.eos_token_id)
            self._n["spec_accepted_tokens"] += accepted
            req.tokens.extend(emitted)
            req.remaining -= len(emitted)
            self._lens[i] += len(emitted)
            self._tok[i] = emitted[-1]
            hit_eos = (self.cfg.eos_token_id is not None
                       and emitted[-1] == self.cfg.eos_token_id)
            if hit_eos or req.remaining == 0:
                self._slots[i] = None
                self._done[i] = True
                self._release_blocks(req)
                self._finish(req, t, out)

    def step(self, now: Optional[float] = None) -> List[Request]:
        """One scheduler iteration: admit into vacant slots, run at
        most one prefill chunk, then one speculative verify forward over
        the spec-mode slots and one decode block over the plain decode
        mix.  Returns the requests that finished this iteration."""
        self._step_idx += 1
        finished: List[Request] = []
        t_now = self._clock() if now is None else now
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
            return finished
        # a full block only when no active request can finish inside it
        # (a block never overshoots a budget); otherwise single steps
        min_budget = min(self._slots[i].remaining for i in active)
        n = 1 if min_budget < self.steps_per_call else self.steps_per_call
        budget = np.zeros((self.num_slots,), np.int32)
        for i in active:
            budget[i] = self._slots[i].remaining
        reqs = [self._slots[i] for i in active]
        pre_lens = np.array(self._lens)
        t_blk = self._clock()
        out = paged_decode_block(
            self._model, self.cfg, n, self._dev(self._tok),
            self._dev(self._lens), self._dev(self._done), self._dev(budget),
            self._dev(self._decode_tables()), self._arenas, wq=self._wq_ctx)
        toks = out[0].cpu().numpy()
        tok, lens, done = (out[1].cpu().numpy(), out[2].cpu().numpy(),
                           out[3].cpu().numpy())
        self._decode_seconds += self._clock() - t_blk
        self._n["decode_steps"] += n
        self._n["busy_slot_steps"] += n * len(active)
        self._n["block_dispatches"] += 1
        self._absorb_block(active, reqs, toks, tok, lens, done, pre_lens,
                           finished)
        return finished

    def _absorb_block(self, active, reqs, toks, tok, lens, done, pre_lens,
                      out: List[Request]):
        """Adopt a decode block's outputs as host truth: extend each
        rider's token stream, charge its per-step KV sweep (scanned step
        s attends up to ``pre_lens + s``, clamped to the row's final
        ``lens`` where an EOS froze it) and retire riders that emitted
        EOS or ran out of budget."""
        self._tok = tok
        self._lens = lens
        eos = self.cfg.eos_token_id
        t = self._clock()
        per = toks.shape[1]
        if toks.size and (int(toks.min()) < 0
                          or int(toks.max()) >= self._vocab):
            raise RuntimeError(
                f"decode block at step {self._step_idx} produced token "
                f"ids outside [0, {self._vocab})")
        self._count_kv_sweep([min(int(pre_lens[i]) + s, int(lens[i]))
                              for i in active for s in range(per)])
        for i, req in zip(active, reqs):
            row = toks[i]
            req.tokens.extend(int(x) for x in row)
            req.remaining -= per
            if (eos is not None and eos in row) or req.remaining == 0:
                self._slots[i] = None
                done[i] = True         # freeze the row until re-use
                self._release_blocks(req)
                self._finish(req, t, out)
        self._done = done

    def run(self, max_iters: Optional[int] = None) -> List[Request]:
        """Drain the queue: admit/prefill/decode until every submitted
        request has finished.  Sleeps only when idle ahead of a future
        arrival.  Returns this call's finished requests in submission
        order."""
        finished: List[Request] = []
        iters = 0
        while self._queue or any(r is not None for r in self._slots):
            now = self._clock()
            if not any(r is not None for r in self._slots):
                next_arrival = min(r.arrival_time for r in self._queue)
                if next_arrival > now:
                    time.sleep(min(0.005, next_arrival - now))
                    continue
            finished.extend(self.step(now))
            iters += 1
            if max_iters is not None and iters > max_iters:
                raise RuntimeError(
                    f"serving loop exceeded max_iters={max_iters} with "
                    f"{len(self._queue)} queued / "
                    f"{sum(r is not None for r in self._slots)} active")
        return sorted(finished, key=lambda r: r.request_id)

    def stats(self) -> dict:
        """Scheduler counters.  ``mean_slot_occupancy`` is the fraction
        of (decode step x slot) cells that held a live request;
        ``prefix_hit_rate`` is block-granular over matchable prompt
        blocks; ``peak_blocks_in_use`` is the pool's refcount>0
        high-water mark; ``decode_seconds`` and ``verify_seconds`` are
        host wall time spent in decode blocks and verify forwards, device
        sync included; ``weight_bytes_swept`` and ``kv_bytes_swept`` are
        the modeled weight and KV streams (every prefill chunk, decode
        step and verify forward reads the whole weight set once).  The
        ``spec_*`` keys cover speculative decoding:
        ``spec_acceptance_rate`` is accepted over drafted tokens and
        ``spec_mean_accepted_len`` accepted draft tokens per verify
        forward, summed over its spec slots."""
        n = self._n
        steps = n["decode_steps"]
        verifies = n["spec_verify_steps"]
        drafted = n["spec_draft_tokens"]
        accepted = n["spec_accepted_tokens"]
        hits, misses = n["prefix_hits"], n["prefix_misses"]
        ttfts = [r.ttft for r in self._finished if r.ttft is not None]
        lats = [r.latency for r in self._finished if r.latency is not None]
        return {
            "num_slots": self.num_slots,
            "kv_cache_dtype": self.kv_cache_dtype,
            "weight_dtype": self.weight_dtype,
            "kv_bytes_swept": int(n["kv_bytes_swept"]),
            "weight_bytes_swept": int(
                (n["prefill_chunks"] + steps + verifies)
                * self._weight_sweep_bytes),
            "finished": n["finished"],
            "prefills": n["prefills"],
            "prefill_chunks": n["prefill_chunks"],
            "decode_steps": steps,
            "busy_slot_steps": n["busy_slot_steps"],
            "block_dispatches": n["block_dispatches"],
            "mean_slot_occupancy": (n["busy_slot_steps"]
                                    / (steps * self.num_slots)
                                    if steps else 0.0),
            "peak_queue": self._peak_queue,
            "blocks_in_use": self._pool.in_use(),
            "peak_blocks_in_use": self._peak_blocks,
            "prefix_hits": hits,
            "prefix_misses": misses,
            "prefix_hit_rate": (hits / (hits + misses)
                                if hits + misses else 0.0),
            "mean_latency_s": (sum(lats) / len(lats)) if lats else None,
            "mean_ttft_s": (sum(ttfts) / len(ttfts)) if ttfts else None,
            "decode_seconds": self._decode_seconds,
            "verify_seconds": self._verify_seconds,
            "spec_verify_steps": int(verifies),
            "spec_draft_hits": int(n["spec_draft_hits"]),
            "spec_draft_misses": int(n["spec_draft_misses"]),
            "spec_draft_tokens": int(drafted),
            "spec_accepted_tokens": int(accepted),
            "spec_acceptance_rate": (accepted / drafted
                                     if drafted else 0.0),
            "spec_mean_accepted_len": (accepted / verifies
                                       if verifies else 0.0),
        }

    def engine_spec(self) -> dict:
        """The engine's immutable identity as one JSON-safe dict, key
        for key the JAX engine's ``engine_spec()``."""
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
            "adapters": None,
            "shard_group": None,
            "role": self.role,
        }
