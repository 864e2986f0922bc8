"""The serving engine's device programs as plain torch functions: port of
``build_chunk_prefill`` (:516) and ``_build_paged_decode_block`` (:350)
of ``paddle_tpu/inference/llm.py`` with ``_pack_paged_kvs`` /
``_flatten_paged_kvs`` (:331-347), float or int8 KV cache, greedy or
sampled, and ``spec_verify``, the body of the speculative verifier
(``inference/speculative.py:296-310``), plus the weight-quantization
plan: ``normalize_weight_dtype``
(:56), ``WeightQuantPlan`` (:83) and ``build_weight_quant_plan`` (:133).

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
``wquant_context(plan.context())``.  The decode block is a Python loop of
``steps`` decode steps; on the card the engine runs it as a captured CUDA
graph (``DecodeBlockGraph``, one per total step count and flag bucket,
the counterpart of the JAX engine's compiled block program), on the CPU
eagerly.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..device import to_dtype
from ..models.generation import GenerationConfig
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
                  flags=NO_FLAGS):
    """ONE prompt chunk of ONE sequence: ids [1, C] at global positions
    ``start .. start+C-1``, K/V written through ``tables`` ([1,
    max_blocks]); ``n_valid`` is the prompt's true length; ``wq`` the
    weight-quant context or None; ``samp``/``flags`` the batch-1 sampling
    planes of the request (at PRNG position 0).  Returns ``(tok [1]
    int32, *flat_arenas)``: the token sampled at prompt position
    ``n_valid - 1``, meaningful only on the chunk that covers it."""
    with wquant_context(wq):
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
                         flags=NO_FLAGS):
    """``paged_decode_block``'s loop with its whole final carry: returns
    ``(toks [B, steps], tok', lens', done', budget', pos', presence')``
    (``pos'`` None without the sampled flag, ``presence'`` None without
    the penalty flag); the arenas are written in place."""
    pos = samp["pos"] if flags[0] else None
    presence = samp["presence"] if flags[2] else None
    carry = (tok, lens, _pack_paged_kvs(flat_arenas, tables), pos, presence,
             done, budget)
    toks = []
    with wquant_context(wq):
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
                       flags=NO_FLAGS):
    """``steps`` decode steps over every slot row.  tok/lens/budget [B]
    int32, done [B] bool, tables [B, max_blocks] int32; ``wq`` the
    weight-quant context or None; ``samp``/``flags`` the sampling planes
    and their flag bucket (all False: greedy, ``samp`` unused).  Returns
    ``(toks [B, steps], tok', lens', done', budget', *flat_arenas)``."""
    out = decode_block_carries(model, cfg, steps, tok, lens, done, budget,
                               tables, flat_arenas, wq=wq, samp=samp,
                               flags=flags)
    return out[:5] + tuple(flat_arenas)


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


class DecodeBlockGraph:
    """``paged_decode_block`` of ``steps`` steps under one sampling flag
    bucket, captured as ONE CUDA graph over static ``tok``/``lens``/
    ``done``/``budget``/``tables`` buffers, the bucket's static sampling
    planes (``samp``, ``plane_buffers``) and the engine's own arenas: the
    counterpart of the JAX engine's compiled block program
    (``_block_fn``), one per total step count and flag bucket, so a fused
    depth-S window of S x n steps replays the same graph as a plain block
    of S x n.

    The capture runs the block once on a side stream first (warm-up),
    on inputs that route every write to the trash row (all rows done,
    all-trash tables, neutral planes), then captures it on the same
    stream, ordered after the current stream's work by stream waits (no
    device-wide synchronize, garbage collection or cache release, which
    ``torch.cuda.graph`` adds); neither runs a launch that the kernel
    counts keep (``_build.launches_taken_out``).  A call copies its
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
    nothing falls back to the eager block."""

    def __init__(self, model, cfg: GenerationConfig, steps: int,
                 num_slots: int, tables_width: int,
                 flat_arenas: Sequence[torch.Tensor],
                 wq: Optional[WeightQuantContext] = None, flags=NO_FLAGS):
        from ..ops import _build
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

        def block():
            return decode_block_carries(
                model, cfg, self.steps, self.tok, self.lens, self.done,
                self.budget, self.tables, arenas, wq=wq, samp=self.samp,
                flags=self.flags)

        side = _CAPTURE_STREAMS.get(dev)
        if side is None:
            side = _CAPTURE_STREAMS[dev] = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        self.launches = {}
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            with _build.launches_taken_out({}):
                block()
            with _build.launches_taken_out(self.launches):
                self.graph.capture_begin()
                try:
                    out = block()
                finally:
                    self.graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.out = tuple(out[:5])
        self.pos, self.presence = out[5], out[6]
        self.replays = 0

    def __call__(self, tok, lens, done, budget, tables, samp=None):
        """Copy the inputs in, replay, count; returns the static
        outputs."""
        from ..ops import _build
        if len(self.arenas) != len(self.arena_ptrs) or any(
                a.data_ptr() != p
                for a, p in zip(self.arenas, self.arena_ptrs)):
            raise RuntimeError(
                f"decode block graph of {self.steps} steps: the arenas "
                f"are not the ones it was captured over")
        pairs = [(self.tok, tok), (self.lens, lens), (self.done, done),
                 (self.budget, budget), (self.tables, tables)]
        if samp is not None:
            if set(samp) != set(self.samp):
                raise ValueError(
                    f"decode block graph of flags {self.flags} takes the "
                    f"planes {sorted(self.samp)}, got {sorted(samp)}")
            pairs += [(self.samp[k], v) for k, v in samp.items()]
        for dst, src in pairs:
            if src is not dst:
                dst.copy_(src, non_blocking=True)
        self.graph.replay()
        _build.add_launches(self.launches)
        self.replays += 1
        return self.out


@torch.no_grad()
def spec_verify(model, toks, lens, n_valid, tables,
                flat_arenas: Sequence[torch.Tensor],
                wq: Optional[WeightQuantContext] = None, samp=None,
                flags=NO_FLAGS):
    """ONE speculative verify forward over every slot row: toks [B, C]
    int32 (each spec row's last emitted token, then its drafts, then
    pad), lens [B] int32 (global slot of column 0), n_valid [B] int32 (a
    row's real columns; 0 for rows not in spec mode, whose tables are
    all trash), tables [B, max_blocks] int32; ``wq`` the weight-quant
    context or None; ``samp``/``flags`` the spec rows' sampling planes.
    Returns ``(greedy [B, C] int32, *flat_arenas)`` (every position's
    argmax of the processed logits, the greedy acceptance path) or, with
    the sampled flag, ``(greedy, u, accept_p, resample, sample,
    *flat_arenas)`` (``sampling.spec_sampling_draws``)."""
    with wquant_context(wq):
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
