"""The device programs of serving as plain torch functions, and the dense
serving session.

The engine's programs: port of ``build_chunk_prefill`` (:516) and
``_build_paged_decode_block`` (:350) of ``paddle_tpu/inference/llm.py``
with ``_pack_paged_kvs`` / ``_flatten_paged_kvs`` (:331-347), float or
int8 KV cache, greedy or sampled, and ``spec_verify``, the body of the
speculative verifier (``inference/speculative.py:296-310``), plus the
weight-quantization plan: ``normalize_weight_dtype`` (:56),
``WeightQuantPlan`` (:83) and ``build_weight_quant_plan`` (:133).

They take and return what the JAX programs take and return, minus the
parameter list (the model holds its weights).  The sampling planes
``samp`` and the static flags ``(sampled, filtered, penalty, bias)`` are
the reference's (``inference/sampling.py``); ``flags`` all False is the
greedy program.  The arenas are updated IN PLACE — the torch counterpart
of the JAX programs' donated arena arguments — and handed back for
symmetry.
The host-RAM tier's swap programs ``build_swap_out_gather`` (:471) and
``build_swap_in_scatter`` (:493) are plain indexing: an ``index_select``
and an in-place ``index_put_``, no kernel.
A weight-quant plan takes the place of ``_param_swapper``'s (:173)
trailing code/scale values: the programs run the model inside
``wquant_context(plan.context())``.  The ``lora=True`` variants of the
chunk, decode-block and verify builders (:353, :518,
``speculative.py:229``) are the same programs given a ``lora`` plane dict
(``{"ids": [B] int32, "a"/"b": {target: arena}}``, ``models/lora.py``):
they gather the per-row adapter stacks and run the model inside
``lora_context``.

Graphs: ``CapturedGraph`` is the one capture discipline of the port
(warm-up and capture on a side stream, launches counted per replay).  On
the card the engine's decode block is a ``DecodeBlockGraph`` (one per
total step count, flag bucket and adapter variant, the counterpart of the
JAX engine's compiled block program), ``generate()`` a ``GenerateGraph``
(one per program key, ``_generate_compiled`` :535 of
``models/generation.py``), and an ``LLMPredictor`` session two graphs; on
the CPU all of them run eagerly.

The dense serving session: ``LLMPredictor`` (:671) with its programs
``session_prefill`` and ``session_block`` over a ``SessionState``
(``_build_serving_fns`` :590 and ``_build_decode_block`` :213; greedy,
sampled or beam) and its artifact ``save``/``load`` (:886-1002).  The
reference serialises StableHLO programs; the port's artifact
(``.ptpu_torch_llm``) holds the meta, the Llama config and the weights,
and ``load`` rebuilds the model and the programs from them.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import time
import weakref
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..device import to_dtype
from ..models.generation import GenerationConfig, generate_program
from ..models.lora import gather_lora, lora_context
from ..models.wquant import WeightQuantContext, wquant_context
from .sampling import (NO_FLAGS, decode_scan_step, sample_rows,
                       spec_greedy_rows, spec_sampling_draws)


def normalize_weight_dtype(weight_dtype) -> Optional[str]:
    """Validate a ``weight_dtype=`` argument: ``None`` for full-precision
    serving (``None`` or any float dtype name) or the canonical
    ``"int8"``/``"int4"`` for quantized code+scale planes.  The allowed
    set is distinct from ``kv_cache_dtype``'s (float dtypes or
    ``"int8"``)."""
    if weight_dtype is None:
        return None
    s = str(weight_dtype)
    if s in ("int8", "int4"):
        return s
    try:
        dt = to_dtype(weight_dtype)
    except ValueError:
        raise ValueError(
            f"weight_dtype must be a float dtype (full-precision "
            f"weights), 'int8' or 'int4' (quantized code+scale planes); "
            f"got {weight_dtype!r}") from None
    if dt.is_floating_point:
        return None
    raise ValueError(
        f"weight_dtype must be a float dtype, 'int8' or 'int4'; got "
        f"{weight_dtype!r} — integer weight arenas other than int8/int4 "
        "have no code+scale discipline")


class WeightQuantPlan:
    """One model's quantized-weight planes: per (layer_idx, target) an
    int8 code plane ([K, N]; int4 packs to [K//2, N]) and a
    per-output-channel f32 scale plane [N], in (layer, declaration)
    order.  ``entries`` are ``(layer_idx, target, param_pos, codes,
    scales)``, ``param_pos`` being the weight's index in
    ``model.parameters()``."""

    def __init__(self, dtype_str, bits, entries):
        self.dtype = dtype_str
        self.bits = bits
        self.entries = entries
        self.param_positions = frozenset(e[2] for e in entries)

    def context(self) -> WeightQuantContext:
        """The projection sites' context (``models/wquant.py``)."""
        return WeightQuantContext(
            {(li, t): (codes, scales)
             for li, t, _pos, codes, scales in self.entries}, self.bits)

    def bytes_swept(self) -> int:
        """Modeled bytes one forward streams for the quantized planes
        (codes at their packed width + f32 scales)."""
        return sum(c.numel() * c.element_size()
                   + s.numel() * s.element_size()
                   for _li, _t, _pos, c, s in self.entries)

    def to(self, device) -> "WeightQuantPlan":
        return WeightQuantPlan(
            self.dtype, self.bits,
            [(li, t, pos, c.to(device), s.to(device))
             for li, t, pos, c, s in self.entries])


@torch.no_grad()
def build_weight_quant_plan(model, weight_dtype) -> WeightQuantPlan:
    """Quantize ``model``'s hot projections once, from the weights as
    stored.  Scales go through ``PerChannelAbsmaxObserver`` and
    ``absmax_to_scales`` (the one quant rule), codes through
    ``quantize_channelwise``; int4 packs two codes per byte
    (``pack_int4``).  A torch ``Linear`` weight is ``[N, K]``: the plan
    quantizes its transpose per output channel and stores codes
    ``[K, N]``, the JAX package's layout, byte for byte."""
    from ..ops.quantized_matmul import pack_int4
    from ..quantization.observers import (PerChannelAbsmaxObserver,
                                          absmax_to_scales,
                                          quantize_channelwise)
    bits = {"int8": 8, "int4": 4}[weight_dtype]
    if not hasattr(model, "quant_projections"):
        raise ValueError(
            f"weight_dtype={weight_dtype!r} needs a model exposing "
            f"quant_projections() (llama); got {type(model).__name__}")
    pos = {id(p): i for i, p in enumerate(model.parameters())}
    entries = []
    for li, layer in enumerate(model.quant_projections()):
        for target, lin in layer.items():
            if not isinstance(lin, torch.nn.Linear):
                raise ValueError(
                    f"weight_dtype={weight_dtype!r} supports plain "
                    f"nn.Linear projections only; layer {li} {target} is "
                    f"{type(lin).__name__}")
            w_kn = lin.weight.t()                            # [K, N]
            obs = PerChannelAbsmaxObserver(quant_axis=-1, bit_length=bits)
            obs.observe(w_kn)
            scales = absmax_to_scales(obs.scales(), bits)
            codes = quantize_channelwise(w_kn, scales, bits, quant_axis=-1)
            if bits == 4:
                codes = pack_int4(codes)
            entries.append((li, target, pos[id(lin.weight)],
                            codes.contiguous(), scales.contiguous()))
    return WeightQuantPlan(weight_dtype, bits, entries)


def _pack_paged_kvs(flat_arenas: Sequence[torch.Tensor], tables):
    """Per-layer paged kv entries from the flat arena list: (k, v,
    tables) triples for a float cache, (k_codes, v_codes, k_scales,
    v_scales, tables) 5-tuples (stride 4) for an int8 cache."""
    stride = 4 if flat_arenas[0].dtype == torch.int8 else 2
    return [tuple(flat_arenas[i:i + stride]) + (tables,)
            for i in range(0, len(flat_arenas), stride)]


def _flatten_paged_kvs(kvs) -> List[torch.Tensor]:
    """Inverse of ``_pack_paged_kvs`` minus the tables."""
    flat = []
    for entry in kvs:
        flat += list(entry[:-1])
    return flat


@torch.no_grad()
def chunk_prefill(model, ids, start: int, n_valid: int, tables,
                  flat_arenas: Sequence[torch.Tensor],
                  wq: Optional[WeightQuantContext] = None, samp=None,
                  flags=NO_FLAGS, lora=None):
    """ONE prompt chunk of ONE sequence: ids [1, C] at global positions
    ``start .. start+C-1``, K/V written through ``tables`` ([1,
    max_blocks]); ``n_valid`` is the prompt's true length; ``wq`` the
    weight-quant context or None; ``samp``/``flags`` the batch-1 sampling
    planes of the request (at PRNG position 0); ``lora`` the batch-1
    adapter planes or None.  Returns ``(tok [1] int32, *flat_arenas)``:
    the token sampled at prompt position ``n_valid - 1``, meaningful only
    on the chunk that covers it."""
    with wquant_context(wq), _lora_scope(lora):
        logits, kvs = model.prefill_chunk(
            ids, start, n_valid, _pack_paged_kvs(flat_arenas, tables))
    tok = sample_rows(logits, samp, flags,
                      samp["presence"] if flags[2] else None)
    return (tok,) + tuple(_flatten_paged_kvs(kvs))


@torch.no_grad()
def decode_block_carries(model, cfg: GenerationConfig, steps: int, tok, lens,
                         done, budget, tables,
                         flat_arenas: Sequence[torch.Tensor],
                         wq: Optional[WeightQuantContext] = None, samp=None,
                         flags=NO_FLAGS, lora=None):
    """``paged_decode_block``'s loop with its whole final carry: returns
    ``(toks [B, steps], tok', lens', done', budget', pos', presence')``
    (``pos'`` None without the sampled flag, ``presence'`` None without
    the penalty flag); the arenas are written in place.  The adapter
    stacks are gathered once, before the loop (the ids are
    loop-invariant)."""
    pos = samp["pos"] if flags[0] else None
    presence = samp["presence"] if flags[2] else None
    carry = (tok, lens, _pack_paged_kvs(flat_arenas, tables), pos, presence,
             done, budget)
    toks = []
    with wquant_context(wq), _lora_scope(lora):
        for _ in range(int(steps)):
            carry, nxt = decode_scan_step(model, cfg, carry, samp, flags)
            toks.append(nxt)
    tok_f, lens_f, _kvs, pos_f, pres_f, done_f, budget_f = carry
    return (torch.stack(toks, dim=1), tok_f, lens_f, done_f, budget_f,
            pos_f, pres_f)


def paged_decode_block(model, cfg: GenerationConfig, steps: int, tok, lens,
                       done, budget, tables,
                       flat_arenas: Sequence[torch.Tensor],
                       wq: Optional[WeightQuantContext] = None, samp=None,
                       flags=NO_FLAGS, lora=None):
    """``steps`` decode steps over every slot row.  tok/lens/budget [B]
    int32, done [B] bool, tables [B, max_blocks] int32; ``wq`` the
    weight-quant context or None; ``samp``/``flags`` the sampling planes
    and their flag bucket (all False: greedy, ``samp`` unused); ``lora``
    the adapter planes (``{"ids": [B] int32, "a", "b"}``; a row without an
    adapter names the arenas' null row) or None.  Returns ``(toks [B,
    steps], tok', lens', done', budget', *flat_arenas)``."""
    out = decode_block_carries(model, cfg, steps, tok, lens, done, budget,
                               tables, flat_arenas, wq=wq, samp=samp,
                               flags=flags, lora=lora)
    return out[:5] + tuple(flat_arenas)


def _lora_scope(planes):
    """The adapter context of one program call: the per-row stacks
    gathered from ``planes`` (inside the call, so a captured graph
    records the gathers), or the no-op context without planes."""
    return lora_context(None if planes is None else gather_lora(planes))


def plane_buffers(flags, num_slots: int, vocab: int, device):
    """Static sampling planes of one flag bucket at their neutral values
    (every row greedy, position 0, no penalty, no bias): the planes
    ``sample_rows`` reads under ``flags``."""
    sampled, _filtered, penalty, bias = flags
    b = num_slots
    planes = {}
    if sampled:
        planes.update(
            base=torch.zeros((b, 2), dtype=torch.int64, device=device),
            pos=torch.zeros(b, dtype=torch.int64, device=device),
            temp=torch.ones(b, dtype=torch.float32, device=device),
            top_k=torch.zeros(b, dtype=torch.int64, device=device),
            top_p=torch.ones(b, dtype=torch.float32, device=device),
            greedy=torch.ones(b, dtype=torch.bool, device=device))
    if penalty:
        planes.update(
            rep=torch.ones(b, dtype=torch.float32, device=device),
            presence=torch.zeros((b, vocab), dtype=torch.bool,
                                 device=device))
    if bias:
        planes["bias"] = torch.zeros((b, vocab), dtype=torch.float32,
                                     device=device)
    return planes


# one side stream per device for warm-ups and captures, made at the first
# capture: cuBLAS keeps a workspace for every stream it has run on, so a
# new stream per capture would grow device memory with every graph
_CAPTURE_STREAMS = {}
# the latest dense program graph of each device (``GenerateGraph``, the
# ``LLMPredictor`` sessions' graphs), held weakly: a new one shares its
# memory pool.  Their replays never overlap and each copies its outputs
# out (or writes them into buffers it owns) before another replays, so
# they can share memory.  A pool is only ever shared through a live
# graph's ``pool()``: once every graph of a pool is gone, torch's
# allocator refuses a capture into it
_DENSE_GRAPHS = {}


def graphs_on(device) -> bool:
    """Whether the dense programs on ``device`` replay captured CUDA
    graphs (the card) or run eagerly (the CPU)."""
    return torch.device(device).type == "cuda"


def _dense_capture(fn, dev, warmup=None) -> "CapturedGraph":
    """``CapturedGraph`` in the device's shared pool of dense programs
    (a new pool when no graph of the last one is alive)."""
    ref = _DENSE_GRAPHS.get(dev)
    live = ref() if ref is not None else None
    prog = CapturedGraph(fn, dev, warmup=warmup,
                         pool=live.pool() if live is not None else None)
    _DENSE_GRAPHS[dev] = weakref.ref(prog.graph)
    return prog


class CapturedGraph:
    """One program captured as ONE CUDA graph, the capture discipline
    every graph of the port shares: ``warmup`` (default ``fn``) runs once
    on the device's side stream (first-use work such as a kernel's
    library load or cuBLAS's workspace for that stream must not happen
    under capture), then ``fn`` is captured on the same stream, ordered
    after the current stream's work by stream waits (no device-wide
    synchronize, garbage collection or cache release, which
    ``torch.cuda.graph`` adds).  Neither runs a launch that the kernel
    counts keep (``_build.launches_taken_out``): ``launches`` holds what
    the capture recorded, and ``replay`` charges it.  ``out`` is what
    ``fn`` returned, the static outputs every replay overwrites.  A
    capture that fails raises; nothing falls back to an eager run.
    ``pool`` shares another graph's memory pool (``graph_pool_handle``)."""

    def __init__(self, fn, device, warmup=None, pool=None):
        from ..ops import _build
        side = _CAPTURE_STREAMS.get(device)
        if side is None:
            side = _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        self.launches = {}
        self.graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.stream(side):
            with _build.launches_taken_out({}):
                (warmup or fn)()
            with _build.launches_taken_out(self.launches):
                self.graph.capture_begin(pool=pool)
                try:
                    self.out = fn()
                finally:
                    self.graph.capture_end()
        torch.cuda.current_stream(device).wait_stream(side)
        self.capture_s = time.perf_counter() - t0
        self.replays = 0

    def replay(self):
        """Replay on the current stream and count the captured launches;
        returns the static outputs."""
        from ..ops import _build
        self.graph.replay()
        _build.add_launches(self.launches)
        self.replays += 1
        return self.out


class DecodeBlockGraph:
    """``paged_decode_block`` of ``steps`` steps under one sampling flag
    bucket, captured as ONE CUDA graph (``CapturedGraph``) over static
    ``tok``/``lens``/``done``/``budget``/``tables`` buffers, the bucket's
    static sampling planes (``samp``, ``plane_buffers``) and the engine's
    own arenas: the counterpart of the JAX engine's compiled block
    program (``_block_fn``), one per total step count, flag bucket and
    adapter variant, so a fused depth-S window of S x n steps replays the
    same graph as a plain block of S x n.

    The warm-up runs on inputs that route every write to the trash row
    (all rows done, all-trash tables, neutral planes).  A call copies its
    inputs (and the given planes) into the static buffers on the current
    stream (device carries device to device; a caller may also write a
    plane straight into ``samp``), replays, adds the captured launches to
    the counts and returns the static outputs ``(toks [B, steps], tok,
    lens, done, budget)``; ``pos``/``presence`` hold the final position
    and presence carries.  The next replay overwrites them: a caller
    that keeps them reads them (or copies them) before it replays this
    graph again.  The arenas' addresses are baked in, so a call raises
    when an entry of ``flat_arenas`` (the engine's own list) no longer
    holds the captured tensor.  A capture or replay that fails raises;
    nothing falls back to the eager block.

    ``lora`` (an ``AdapterStore``'s ``arena_planes()``) captures the
    adapter variant: a static ``ids [num_slots]`` int32 buffer (every row
    at the null adapter for the warm-up) and the gathers of the store's
    arenas inside the graph, so every replay re-gathers the rows the
    arenas hold then (a swap-in writes its slot in place).  A call raises
    when a store arena no longer holds the captured tensor either."""

    def __init__(self, model, cfg: GenerationConfig, steps: int,
                 num_slots: int, tables_width: int,
                 flat_arenas: Sequence[torch.Tensor],
                 wq: Optional[WeightQuantContext] = None, flags=NO_FLAGS,
                 lora: Optional[dict] = None):
        dev = flat_arenas[0].device
        if dev.type != "cuda":
            raise ValueError(f"a CUDA graph needs CUDA arenas, got {dev}")
        self.steps = int(steps)
        self.flags = tuple(bool(f) for f in flags)
        self.arenas = flat_arenas
        self.arena_ptrs = [a.data_ptr() for a in flat_arenas]
        trash = flat_arenas[0].shape[0] - 1
        i32 = dict(dtype=torch.int32, device=dev)
        self.tok = torch.zeros(num_slots, **i32)
        self.lens = torch.zeros(num_slots, **i32)
        self.done = torch.ones(num_slots, dtype=torch.bool, device=dev)
        self.budget = torch.zeros(num_slots, **i32)
        self.tables = torch.full((num_slots, tables_width), trash, **i32)
        self.samp = plane_buffers(self.flags, num_slots,
                                  int(model.config.vocab_size), dev)
        arenas = list(flat_arenas)
        self.lora = lora
        planes = None
        if lora is not None:
            null = next(iter(lora["a"].values())).shape[0] - 1
            self.ids = torch.full((num_slots,), null, **i32)
            self.lora_ptrs = self._lora_ptrs(lora)
            planes = {"ids": self.ids, "a": dict(lora["a"]),
                      "b": dict(lora["b"])}

        def block():
            return decode_block_carries(
                model, cfg, self.steps, self.tok, self.lens, self.done,
                self.budget, self.tables, arenas, wq=wq, samp=self.samp,
                flags=self.flags, lora=planes)

        self.prog = CapturedGraph(block, dev)
        out = self.prog.out
        self.out = tuple(out[:5])
        self.pos, self.presence = out[5], out[6]

    @property
    def replays(self) -> int:
        return self.prog.replays

    @staticmethod
    def _lora_ptrs(lora: dict):
        return [(half, t, arena.data_ptr())
                for half in ("a", "b") for t, arena in sorted(
                    lora[half].items())]

    def __call__(self, tok, lens, done, budget, tables, samp=None,
                 ids=None):
        """Copy the inputs in, replay, count; returns the static
        outputs.  ``ids`` is the adapter variant's per-row slot ids."""
        if len(self.arenas) != len(self.arena_ptrs) or any(
                a.data_ptr() != p
                for a, p in zip(self.arenas, self.arena_ptrs)):
            raise RuntimeError(
                f"decode block graph of {self.steps} steps: the arenas "
                f"are not the ones it was captured over")
        if (ids is None) != (self.lora is None):
            raise ValueError(
                f"decode block graph of {self.steps} steps was captured "
                f"{'with' if self.lora is not None else 'without'} "
                f"adapter planes")
        pairs = [(self.tok, tok), (self.lens, lens), (self.done, done),
                 (self.budget, budget), (self.tables, tables)]
        if ids is not None:
            if self._lora_ptrs(self.lora) != self.lora_ptrs:
                raise RuntimeError(
                    f"decode block graph of {self.steps} steps: the "
                    f"adapter arenas are not the ones it was captured "
                    f"over")
            pairs.append((self.ids, ids))
        if samp is not None:
            if set(samp) != set(self.samp):
                raise ValueError(
                    f"decode block graph of flags {self.flags} takes the "
                    f"planes {sorted(self.samp)}, got {sorted(samp)}")
            pairs += [(self.samp[k], v) for k, v in samp.items()]
        for dst, src in pairs:
            if src is not dst:
                dst.copy_(src, non_blocking=True)
        self.prog.replay()
        return self.out


class GenerateGraph:
    """``generate_program`` (``models/generation.py``) of one key — (B,
    prompt length S, ``max_cache_len``, ``GenerationConfig``, parameter
    structure) — captured as ONE CUDA graph (``CapturedGraph``): the
    parameter casts where a dtype differs from ``compute_dtype`` (so each
    replay re-reads the live parameters), the caches' zero fill, the
    prefill (flash forward, RoPE, RMSNorm kernels), the first draw and
    ``max_new_tokens - 1`` dense decode steps, and for beams the
    expansion, the per-step cache reorder, the backtrace and the pick.
    The counterpart of the reference's compiled program
    (``_generate_compiled``).  Its inputs are static ``ids [B, S]``,
    ``lens [B]`` and ``key [2]`` buffers; the warm-up runs the same
    program cut to at most two tokens.  A call copies the inputs in,
    replays, counts the captured launches and returns a copy of the
    tokens (the next replay of any dense program may overwrite them: they
    share a memory pool, ``_dense_capture``)."""

    def __init__(self, model, cfg: GenerationConfig, batch: int,
                 prompt_len: int, max_cache_len: int):
        dev = next(model.parameters()).device
        if not graphs_on(dev):
            raise ValueError(f"a CUDA graph needs a CUDA model, got {dev}")
        self.ids = torch.zeros((batch, prompt_len), dtype=torch.int32,
                               device=dev)
        self.lens = torch.full((batch,), prompt_len, dtype=torch.int32,
                               device=dev)
        self.key = torch.zeros(2, dtype=torch.int64, device=dev)
        short = dataclasses.replace(
            cfg, max_new_tokens=min(int(cfg.max_new_tokens), 2))

        def program(c):
            return generate_program(model, c, self.ids, self.lens, self.key,
                                    max_cache_len)

        self.prog = _dense_capture(lambda: program(cfg), dev,
                                   warmup=lambda: program(short))

    def __call__(self, ids, lens, key):
        self.ids.copy_(ids)
        self.lens.copy_(lens)
        self.key.copy_(key)
        return self.prog.replay().clone()


@torch.no_grad()
def spec_verify(model, toks, lens, n_valid, tables,
                flat_arenas: Sequence[torch.Tensor],
                wq: Optional[WeightQuantContext] = None, samp=None,
                flags=NO_FLAGS, lora=None):
    """ONE speculative verify forward over every slot row: toks [B, C]
    int32 (each spec row's last emitted token, then its drafts, then
    pad), lens [B] int32 (global slot of column 0), n_valid [B] int32 (a
    row's real columns; 0 for rows not in spec mode, whose tables are
    all trash), tables [B, max_blocks] int32; ``wq`` the weight-quant
    context or None; ``samp``/``flags`` the spec rows' sampling planes;
    ``lora`` the adapter planes or None (each spec row's positions are
    scored by its own adapter's distribution).  Returns ``(greedy [B, C] int32, *flat_arenas)`` (every position's
    argmax of the processed logits, the greedy acceptance path) or, with
    the sampled flag, ``(greedy, u, accept_p, resample, sample,
    *flat_arenas)`` (``sampling.spec_sampling_draws``)."""
    with wquant_context(wq), _lora_scope(lora):
        logits, kvs = model.verify_step(
            toks, lens, n_valid, _pack_paged_kvs(flat_arenas, tables))
    flat = tuple(_flatten_paged_kvs(kvs))
    pres = samp["presence"] if flags[2] else None
    if flags[0]:
        return spec_sampling_draws(logits, toks, samp, flags, pres) + flat
    return (spec_greedy_rows(logits, toks, samp, flags, pres),) + flat


def build_swap_out_gather():
    """Swap-out reader for the host-RAM block tier: ``(ids [W],
    *flat_arenas) -> tuple of [W, ...] row stacks``, one ``index_select``
    per arena.  Preemption gathers a slot's table row and the radix
    cache's demotion a reclaimed batch, both at table width ``W`` with
    trash-padded ids.  The rows are the blocks' exact at-rest bytes
    (float K/V, or int8 codes plus their f32 scale planes); rows gathered
    from the trash row are finite garbage the callers drop."""
    def gather(ids, *flat_arenas):
        return tuple(a.index_select(0, ids) for a in flat_arenas)
    return gather


def build_swap_in_scatter(n_arenas: int):
    """Re-scatter for host-RAM -> arena restores: ``(ids [W], *rows
    (n_arenas of [W, ...]), *flat_arenas) -> flat_arenas``, each arena
    written in place by ``index_put_`` (where the JAX program donates
    them).  Preemption resume and the radix cache's promotion share it.
    Entries of ``ids`` past the payload name the trash row, so pad rows
    land there as every paged writer's masked writes do.  The rows must
    already be the arena's dtype (``index_put_`` refuses another): a
    restore never casts."""
    def scatter(ids, *rows_and_arenas):
        rows = rows_and_arenas[:n_arenas]
        arenas = rows_and_arenas[n_arenas:]
        for a, r in zip(arenas, rows):
            a.index_put_((ids,), r)
        return tuple(arenas)
    return scatter


# ---- the dense serving session: LLMPredictor ----

ARTIFACT_SUFFIX = ".ptpu_torch_llm"
ARTIFACT_VERSION = 1


class SessionState:
    """The device state an ``LLMPredictor`` owns, the inputs and outputs
    of both session programs: the prompt inputs (``ids [B, P]``, ``lens_in
    [B]``, ``key_in [2]``), the dense caches of ``B * K`` rows and the
    carries (``tok``/``lens`` ``[B * K]``; greedy/sampled ``done [B]`` and
    the threaded ``key [2]``; beam ``done``/``log_probs``/``beam_len``
    ``[B, K]``).  K is ``num_beams``."""

    def __init__(self, model, cfg: GenerationConfig, batch: int,
                 prompt_len: int, max_cache_len: int):
        from ..models.generation import init_kv_cache
        dev = next(model.parameters()).device
        k = int(cfg.num_beams)
        rows = batch * k
        n_layers, hkv, d = model.kv_cache_spec()
        kdt = to_dtype(cfg.cache_dtype or cfg.compute_dtype)
        i32 = dict(dtype=torch.int32, device=dev)
        self.ids = torch.zeros((batch, prompt_len), **i32)
        self.lens_in = torch.full((batch,), prompt_len, **i32)
        self.key_in = torch.zeros(2, dtype=torch.int64, device=dev)
        self.kvs = init_kv_cache(n_layers, rows, max_cache_len, hkv, d, kdt,
                                 dev)
        self.tok = torch.zeros(rows, **i32)
        self.lens = torch.zeros(rows, **i32)
        if k > 1:
            self.done = torch.ones((batch, k), dtype=torch.bool, device=dev)
            self.log_probs = torch.zeros((batch, k), dtype=torch.float32,
                                         device=dev)
            self.beam_len = torch.ones((batch, k), **i32)
        else:
            self.done = torch.ones(batch, dtype=torch.bool, device=dev)
            self.key = torch.zeros(2, dtype=torch.int64, device=dev)


@torch.no_grad()
def session_prefill(model, cfg: GenerationConfig, st: SessionState,
                    wq: Optional[WeightQuantContext] = None):
    """The session's prefill program (``_build_serving_fns``' prefill):
    casts where a dtype differs, prefills ``st.ids``/``st.lens_in`` into
    zero-filled caches and sets the carries.  Greedy/sampled: the first
    draw (``st.key_in`` split first when sampled, the second half carried
    in ``st.key``); returns ``(tok0 [B] int32,)``.  Beam: the top-K
    expansion, every cache row repeated to ``[B*K]`` rows; returns
    ``(tok0 [B, K] int32, log_probs [B, K], beam_len [B, K])``."""
    from ..models.generation import (_params_as, beam_expand,
                                     init_kv_cache, sample_token)
    from . import threefry
    b = st.ids.shape[0]
    k = int(cfg.num_beams)
    with _params_as(model, to_dtype(cfg.compute_dtype)), \
            wquant_context(wq):
        if k > 1:
            n_layers, hkv, d = model.kv_cache_spec()
            kvs = init_kv_cache(n_layers, b, st.kvs[0][0].shape[1], hkv, d,
                                st.kvs[0][0].dtype, st.ids.device)
            logits, kvs = model.prefill(st.ids, st.lens_in, kvs)
            tok0, lens_bk, lp, blen, done = beam_expand(logits, st.lens_in,
                                                        cfg)
            for dst, src in zip(st.kvs, kvs):
                for dc, sc in zip(dst, src):
                    dc.view((b, k) + tuple(dc.shape[1:])).copy_(
                        sc[:, None].expand((b, k) + tuple(sc.shape[1:])))
            st.tok.copy_(tok0.reshape(-1))
            st.lens.copy_(lens_bk)
            st.done.copy_(done)
            st.log_probs.copy_(lp)
            st.beam_len.copy_(blen)
            return tok0, lp, blen
        for kc, vc in st.kvs:
            kc.zero_()
            vc.zero_()
        logits, _ = model.prefill(st.ids, st.lens_in, st.kvs)
        key0, keyr = (threefry.split(st.key_in) if cfg.do_sample
                      else (st.key_in, st.key_in))
        tok0 = sample_token(logits, key0, cfg)
        done0 = (torch.zeros((b,), dtype=torch.bool, device=st.ids.device)
                 if cfg.eos_token_id is None else tok0 == cfg.eos_token_id)
        st.tok.copy_(tok0)
        st.lens.copy_(st.lens_in)
        st.done.copy_(done0)
        st.key.copy_(keyr)
        return (tok0,)


@torch.no_grad()
def session_block(model, cfg: GenerationConfig, steps: int,
                  st: SessionState,
                  wq: Optional[WeightQuantContext] = None):
    """The session's decode-block program (``_build_decode_block`` and the
    beam block of ``_build_serving_fns``): ``steps`` decode steps from the
    carries of ``st``, the caches written in place and the final carries
    written back into ``st``.  Greedy/sampled returns ``(toks [B, steps]
    int32,)``; beam returns ``(tokens, parents, log_probs, beam_len)``,
    each ``[steps, B, K]``, the per-step tree the host backtraces."""
    from ..models.generation import (_params_as, beam_scan_body,
                                     decode_scan_body)
    k = int(cfg.num_beams)
    with _params_as(model, to_dtype(cfg.compute_dtype)), \
            wquant_context(wq):
        if k > 1:
            carry = (st.tok, st.lens, st.kvs, st.log_probs, st.beam_len,
                     st.done)
            body = beam_scan_body(model, cfg, st.done.shape[0], k)
            outs = []
            for _ in range(int(steps)):
                carry, emitted = body(carry)
                outs.append(emitted)
            tok, lens, _kvs, lp, blen, done = carry
            st.log_probs.copy_(lp)
            st.beam_len.copy_(blen)
        else:
            carry = (st.tok, st.lens, st.kvs, st.key, st.done)
            body = decode_scan_body(model, cfg)
            outs = []
            for _ in range(int(steps)):
                carry, nxt = body(carry)
                outs.append(nxt)
            tok, lens, _kvs, key, done = carry
            st.key.copy_(key)
        st.tok.copy_(tok)
        st.lens.copy_(lens)
        st.done.copy_(done)
    if k > 1:
        return tuple(torch.stack(x) for x in zip(*outs))
    return (torch.stack(outs, dim=1),)


def _host(tensors):
    """Numpy copies of a program's outputs: a graph's outputs are static
    buffers that its next replay overwrites."""
    return [t.cpu().numpy().copy() for t in tensors]


class LLMPredictor:
    """Cached-KV generative serving session: port of
    ``paddle_tpu/inference/llm.py:671`` ``LLMPredictor``.

    Shapes are static per predictor: ``batch`` sequences, right-padded
    prompts of ``prompt_len``, cache capacity ``max_cache_len``.
    ``start()`` prefills and returns the first generated token (or the
    initial beams); ``decode(n)`` continues n more tokens (blocks of
    ``steps_per_call``, the surplus buffered for the next call);
    ``generate()`` is both (beam: the whole tree, backtraced on the host
    and scored at exactly ``max_new_tokens``).  ``weight_dtype="int8"|
    "int4"`` serves the projections through quantized code+scale planes
    (``build_weight_quant_plan``).

    The predictor owns one ``SessionState``: the caches and carries of
    both programs.  On the card the prefill and the block are two CUDA
    graphs (``CapturedGraph``, captured at construction) over that state;
    each block replay writes its final carries back into the buffers it
    reads.  On the CPU both run eagerly.  The session reads the model's
    live parameters (a cast copy inside each program only where a dtype
    differs from ``compute_dtype``): an in-place update of the model is
    seen by the session, where the reference snapshots the parameter
    arrays at construction; a rebinding of a parameter makes a graph
    replay raise."""

    def __init__(self, model=None, *, batch, prompt_len,
                 max_cache_len=None, steps_per_call=16,
                 eos_token_id=None, pad_token_id=0,
                 do_sample=False, temperature=1.0, top_k=0, top_p=1.0,
                 num_beams=1, length_penalty=0.0,
                 compute_dtype="bfloat16", cache_dtype=None,
                 weight_dtype=None, _loaded=False):
        from ..models.generation import parameter_structure
        self.batch = int(batch)
        self.prompt_len = int(prompt_len)
        self.max_cache_len = int(max_cache_len or (prompt_len + 256))
        self.steps_per_call = int(steps_per_call)
        if self.max_cache_len < self.prompt_len + 1:
            raise ValueError(
                f"max_cache_len ({self.max_cache_len}) must be >= "
                f"prompt_len + 1 ({self.prompt_len + 1}) — the cache "
                "holds the prompt plus at least the first generated "
                "token's K/V")
        if num_beams > 1 and do_sample:
            raise ValueError("num_beams > 1 with do_sample=True is not "
                             "supported (beam search scores greedily)")
        self.cfg = GenerationConfig(
            do_sample=bool(do_sample), temperature=float(temperature),
            top_k=int(top_k), top_p=float(top_p),
            num_beams=int(num_beams),
            length_penalty=float(length_penalty),
            eos_token_id=eos_token_id, pad_token_id=int(pad_token_id),
            compute_dtype=str(compute_dtype),
            cache_dtype=None if cache_dtype is None else str(cache_dtype))
        self._written = 0        # python-side high-water mark
        # a block emits steps_per_call tokens; tokens beyond what the
        # caller asked for are buffered here and drained first on the
        # next decode() (the device carry is always block-aligned)
        self._pending: Optional[np.ndarray] = None
        self._started = False
        self.weight_dtype = normalize_weight_dtype(weight_dtype)
        if _loaded and self.weight_dtype is not None:
            raise ValueError(
                "weight_dtype is a load-time quantization of the "
                "in-process model; a deserialized artifact carries "
                "its weights as saved")
        if model is None:
            raise ValueError("LLMPredictor needs a model (or .load(path))")
        cdt = to_dtype(self.cfg.compute_dtype)
        if to_dtype(self.cfg.cache_dtype or self.cfg.compute_dtype) != cdt:
            # the dense decode kernel takes one dtype (generate() refuses
            # the same pair)
            raise NotImplementedError(
                f"LLMPredictor(cache_dtype={cache_dtype!r}) other than "
                f"compute_dtype ({compute_dtype!r}) is not ported yet "
                f"(ROADMAP.md, Queue 1: LLMPredictor and the dense "
                f"generate programs)")
        self._model = model
        model.eval()
        self.device = next(model.parameters()).device
        self._wq = (build_weight_quant_plan(model, self.weight_dtype).to(
            self.device) if self.weight_dtype is not None else None)
        wq = self._wq.context() if self._wq is not None else None
        cfg, steps = self.cfg, self.steps_per_call
        st = self._st = SessionState(model, cfg, self.batch,
                                     self.prompt_len, self.max_cache_len)

        def prefill():
            return session_prefill(model, cfg, st, wq)

        def block():
            return session_block(model, cfg, steps, st, wq)

        if not graphs_on(self.device):
            self._prefill, self._block = prefill, block
            return
        self._prefill_graph = _dense_capture(prefill, self.device)
        # the block's warm-up must write in range whatever the prompt
        # length: every row frozen at slot 0 (start() prefills again)
        st.lens.zero_()
        st.done.fill_(True)
        self._block_graph = _dense_capture(block, self.device)
        self._struct = parameter_structure(model)
        self._prefill = lambda: self._replay(self._prefill_graph)
        self._block = lambda: self._replay(self._block_graph)

    def _replay(self, graph: CapturedGraph):
        from ..models.generation import parameter_structure
        if parameter_structure(self._model) != self._struct:
            raise RuntimeError(
                "LLMPredictor: the model's parameters were rebound (or "
                "moved or cast) after its graphs were captured; build a "
                "new predictor")
        return graph.replay()

    # -- session --
    def _check_prompt(self, input_ids, seq_lens):
        ids = np.asarray(input_ids.cpu() if isinstance(
            input_ids, torch.Tensor) else input_ids)
        if ids.shape != (self.batch, self.prompt_len):
            raise ValueError(
                f"prompt must be [{self.batch}, {self.prompt_len}], got "
                f"{list(ids.shape)}")
        lens = (np.full((self.batch,), self.prompt_len, np.int32)
                if seq_lens is None
                else np.asarray(seq_lens.cpu() if isinstance(
                    seq_lens, torch.Tensor) else seq_lens))
        if lens.shape != (self.batch,) or (lens < 1).any() or \
                (lens > self.prompt_len).any():
            # an out-of-range length would read another row's or no
            # position at all: fail loudly here
            raise ValueError(
                f"seq_lens must be [{self.batch}] ints in "
                f"[1, {self.prompt_len}], got {lens.tolist()}")
        return ids, lens

    def start(self, input_ids, seq_lens=None, seed: int = 0) -> np.ndarray:
        """Prefill the prompt; returns the first generated token [B]
        (greedy/sampled) or the initial beams [B, K] (beam mode)."""
        from . import threefry
        ids, lens = self._check_prompt(input_ids, seq_lens)
        st = self._st
        st.ids.copy_(torch.from_numpy(ids.astype(np.int32)))
        st.lens_in.copy_(torch.from_numpy(lens.astype(np.int32)))
        if self.cfg.num_beams == 1:
            st.key_in.copy_(threefry.as_key(threefry.prng_key(seed)))
        out = _host(self._prefill())
        if self.cfg.num_beams > 1:
            # host-side beam tree: ids/parents/scores [T, B, K]
            k = self.cfg.num_beams
            self._tree_ids = [out[0][None]]
            self._tree_parents = [np.tile(
                np.arange(k, dtype=np.int32)[None, None],
                (1, self.batch, 1))]
            self._tree_lp = [out[1][None]]
            self._tree_blen = [out[2][None]]
        self._started = True
        self._written = int(lens.max()) + 1
        self._pending = None
        return out[0]

    def _run_block(self):
        out = _host(self._block())
        if self.cfg.num_beams > 1:
            self._tree_ids.append(out[0])
            self._tree_parents.append(out[1])
            self._tree_lp.append(out[2])
            self._tree_blen.append(out[3])
            return None  # beam tokens are final only after backtrace
        return out[0]

    def decode(self, n: int) -> np.ndarray:
        """Decode ``n`` more tokens; returns [B, n] int32.  Beam mode
        has no incremental token stream (beams reorder retroactively):
        use ``generate()``."""
        if self.cfg.num_beams > 1:
            raise RuntimeError(
                "decode() is not available with num_beams > 1 — beam "
                "tokens are only final after the last step's backtrace; "
                "use generate(), which returns the best sequences")
        if not self._started:
            raise RuntimeError("call start() before decode()")
        if n <= 0:
            return np.zeros((self.batch, 0), np.int32)
        buffered = 0 if self._pending is None else self._pending.shape[1]
        need_blocks = max(0, -(-(n - buffered) // self.steps_per_call))
        if self._written + need_blocks * self.steps_per_call \
                > self.max_cache_len + 1:
            raise ValueError(
                f"decoding {n} more tokens exceeds max_cache_len "
                f"({self.max_cache_len}); session has written "
                f"{self._written}")
        chunks: List[np.ndarray] = ([] if self._pending is None
                                    else [self._pending])
        for _ in range(need_blocks):
            chunks.append(self._run_block())
            self._written += self.steps_per_call
        all_toks = np.concatenate(chunks, axis=1)
        self._pending = all_toks[:, n:] if all_toks.shape[1] > n else None
        return all_toks[:, :n]

    def generate(self, input_ids, seq_lens=None,
                 max_new_tokens: int = 32, seed: int = 0) -> np.ndarray:
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        first = self.start(input_ids, seq_lens, seed=seed)
        if self.cfg.num_beams > 1:
            n_blocks = -(-(max_new_tokens - 1) // self.steps_per_call)
            if self._written + n_blocks * self.steps_per_call \
                    > self.max_cache_len + 1:
                raise ValueError(
                    f"decoding {max_new_tokens} tokens exceeds "
                    f"max_cache_len ({self.max_cache_len})")
            for _ in range(n_blocks):
                self._run_block()
                self._written += self.steps_per_call
            return self._finalize_beams(max_new_tokens)
        if max_new_tokens == 1:
            return first[:, None]
        rest = self.decode(max_new_tokens - 1)
        return np.concatenate([first[:, None], rest], axis=1)

    def _finalize_beams(self, max_new_tokens: int) -> np.ndarray:
        """Backtrace the accumulated (token, parent) tree and return the
        best beam per batch row under the length penalty, scored at
        exactly ``max_new_tokens`` (not at the block boundary the last
        block ran to)."""
        from ..models.generation import beam_pick
        from ..nn.functional import gather_tree
        ids = np.concatenate(self._tree_ids, axis=0)[:max_new_tokens]
        parents = np.concatenate(self._tree_parents,
                                 axis=0)[:max_new_tokens]
        seqs = gather_tree(ids, parents)                       # [T, B, K]
        lp = np.concatenate(self._tree_lp, axis=0)[max_new_tokens - 1]
        blen = np.concatenate(self._tree_blen, axis=0)[max_new_tokens - 1]
        return beam_pick(seqs, torch.from_numpy(lp), torch.from_numpy(blen),
                         self.cfg.length_penalty).numpy()

    # -- artifact --
    def _meta(self):
        c = self.cfg
        return {"batch": self.batch, "prompt_len": self.prompt_len,
                "max_cache_len": self.max_cache_len,
                "steps_per_call": self.steps_per_call,
                "eos_token_id": c.eos_token_id,
                "pad_token_id": c.pad_token_id, "do_sample": c.do_sample,
                "temperature": c.temperature, "top_k": c.top_k,
                "top_p": c.top_p, "num_beams": c.num_beams,
                "length_penalty": c.length_penalty,
                "compute_dtype": c.compute_dtype,
                "cache_dtype": c.cache_dtype}

    def save(self, path: str):
        """Write the serving artifact ``path + ".ptpu_torch_llm"``: a
        pickle of the format ``version``, the reference's ``meta`` dict
        (the full decode configuration: greedy, sampled or beam), the
        model family and its ``LlamaConfig`` fields, and every weight as
        numpy at its exact bits (bf16 as the ``uint16`` view plus the
        dtype name, the host parcels' rule).  ``load()`` rebuilds the
        model and the programs from it alone.  The reference's
        ``.ptpu_llm`` holds StableHLO programs: neither package loads the
        other's artifact."""
        from ..models.llama import LlamaForCausalLM
        from .prefixcache import host_rows
        if self._wq is not None:
            raise NotImplementedError(
                "save() with weight_dtype='int8'/'int4' is not wired — "
                "the artifact would carry the code/scale planes without "
                "the loader knowing the plan layout; quantized-weight "
                "predictors serve in-process")
        if not isinstance(self._model, LlamaForCausalLM):
            raise NotImplementedError(
                f"save() serialises a LlamaForCausalLM, got "
                f"{type(self._model).__name__} (ROADMAP.md, Queue 1: #12 "
                f"Model zoo)")
        blob = {"version": ARTIFACT_VERSION, "family": "llama",
                "config": dataclasses.asdict(self._model.config),
                "meta": self._meta(),
                "weights": {name: host_rows(t) for name, t in
                            self._model.state_dict().items()}}
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path + ARTIFACT_SUFFIX, "wb") as f:
            pickle.dump(blob, f, protocol=pickle.HIGHEST_PROTOCOL)

    @classmethod
    def load(cls, path: str, device="cuda") -> "LLMPredictor":
        """Rebuild a serving session from a ``.ptpu_torch_llm`` artifact
        written by ``save()``: the model (``LlamaForCausalLM`` of the
        saved config, every weight at its saved bits and dtype) on
        ``device`` (the CUDA card unless ``"cpu"`` is asked for; raises
        without CUDA) and the programs of the saved configuration."""
        from ..device import resolve_device
        from ..models.llama import LlamaConfig, LlamaForCausalLM
        from .prefixcache import parcel_tensor
        dev = resolve_device(device)
        with open(path + ARTIFACT_SUFFIX, "rb") as f:
            blob = pickle.load(f)
        if blob.get("version") != ARTIFACT_VERSION or \
                blob.get("family") != "llama":
            raise ValueError(
                f"{path}{ARTIFACT_SUFFIX}: artifact version "
                f"{blob.get('version')!r} of family {blob.get('family')!r}; "
                f"this loader reads version {ARTIFACT_VERSION} of 'llama'")
        weights = blob["weights"]
        model = LlamaForCausalLM(LlamaConfig(**blob["config"]), device=dev,
                                 dtype=next(iter(weights.values()))[1],
                                 init=False)
        names = dict(model.named_parameters())
        if set(names) != set(weights):
            raise ValueError(
                f"{path}{ARTIFACT_SUFFIX}: weights "
                f"{sorted(set(weights) ^ set(names))} do not match the "
                f"model of its config")
        with torch.no_grad():
            for name, p in names.items():
                bits, dt = weights[name]
                if dt != str(p.dtype).replace("torch.", ""):
                    p.data = torch.empty(p.shape, dtype=to_dtype(dt),
                                         device=dev)
                p.copy_(parcel_tensor(bits, dt, p))
        return cls(model, **blob["meta"], _loaded=True)
