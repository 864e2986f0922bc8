"""Speculative decoding: the drafters, the greedy acceptance rule and the
verifier.  Port of ``paddle_tpu/inference/speculative.py``.

A DRAFTER proposes up to K candidate tokens per sequence; ONE target
forward (the model's ``verify_step``, Llama's or GPT's, over the paged
arena, whose attention is the K-wide verify kernel on the card) scores
all K+1 positions.  For a greedy row the longest draft prefix that
matches the target's own argmax is accepted and the first mismatch's
argmax is emitted as the correction token: every emitted token is a
token the sequential greedy loop would have produced.  For a sampled
row draft j is accepted with probability ``p_j(d_j)`` and the first
rejection emits a draw from the residual (speculative sampling): the
output distribution is the sequential sampled engine's.

- ``Drafter`` and ``NGramDrafter`` (:55, :70) are pure numpy, copied.
- ``ModelDrafter`` (:117) runs a draft model's greedy ``generate()``
  (``models/generation.py``: dense prefill, then decode steps through the
  dense decode kernel) on a fixed ``max_context`` grid: one shape, so on
  the card every proposal replays one captured graph.
- ``accept_drafts`` (:196) and ``accept_drafts_sampled`` (:160) are the
  greedy and the stochastic rules, copied.
- ``build_spec_verify`` (:227) is the eager counterpart of the compiled
  verifier with its flag buckets (greedy, sampled, penalised), over a
  float or int8 KV cache and float or quantized weights, with or without
  per-row LoRA adapters (``lora=True``; the drafter stays on the base
  model, as in the reference).  A mesh is not ported (ROADMAP.md, Queue
  1).

KV rollback costs nothing: the verify forward writes all K+1 positions'
K/V through the row's block table (pad columns trash-routed), and a
rejected draft suffix is simply not covered by the row's ``lens``; the
next forward overwrites it before ``lens`` reaches it.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .llm import spec_verify


class Drafter:
    """Draft-proposal interface for speculative decoding.

    ``propose(context, k)`` returns up to ``k`` candidate continuation
    tokens (1-D int32, possibly empty) for a sequence whose full token
    history (prompt plus everything emitted so far, including the
    still-unfed last token) is ``context``.  Proposals are suggestions:
    the verifier keeps the output exact whatever comes back."""

    def propose(self, context: np.ndarray, k: int) -> np.ndarray:
        raise NotImplementedError


class NGramDrafter(Drafter):
    """Prompt-lookup self-drafting: propose the continuation of the
    most recent PRIOR occurrence of the sequence's trailing n-gram.

    Longest n first (``max_ngram`` down to ``min_ngram``); among the
    occurrences of that n-gram the most recent one that still has a full
    k-token continuation is used (else the earliest, whose continuation
    is the longest there is).  Pure host-side numpy; deterministic."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"{min_ngram}..{max_ngram}")
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)

    def propose(self, context: np.ndarray, k: int) -> np.ndarray:
        ctx = np.asarray(context).reshape(-1).astype(np.int32)
        n_ctx = int(ctx.size)
        if k < 1 or n_ctx < self.min_ngram + 1:
            return np.zeros((0,), np.int32)
        from numpy.lib.stride_tricks import sliding_window_view
        for n in range(min(self.max_ngram, n_ctx - 1),
                       self.min_ngram - 1, -1):
            pattern = ctx[n_ctx - n:]
            # windows over ctx[:-1]: window i covers ctx[i:i+n], so its
            # end i+n <= n_ctx-1 — always a PRIOR occurrence, never the
            # trailing n-gram matching itself
            windows = sliding_window_view(ctx[:-1], n)
            hits = np.nonzero((windows == pattern).all(axis=1))[0]
            if hits.size:
                starts = hits + n              # just past each match
                full = starts[starts <= n_ctx - k]
                i = int(full[-1]) if full.size else int(starts[0])
                cont = ctx[i:i + k]
                if cont.size:
                    return cont.astype(np.int32)
        return np.zeros((0,), np.int32)


class ModelDrafter(Drafter):
    """Draft-model proposals through greedy ``generate()``: the draft
    model continues the context by ``max_draft`` tokens (a dense prefill
    and ``max_draft - 1`` decode steps).

    The context is right-padded onto a fixed ``max_context`` grid and
    LEFT-truncated to it when longer (drafts are suggestions: a sliding
    window costs acceptance, never correctness), so every call has one
    shape: a prefill of ``max_context`` positions over a dense cache of
    ``max_context + max_draft`` slots.  The draft model must share the
    target's vocabulary and lie on the target's device; it needs no other
    relation to the target.  On the card each proposal replays the one
    captured graph of that shape (``generate()``)."""

    def __init__(self, model, *, max_context: int, max_draft: int = 8,
                 compute_dtype: str = "float32", pad_token_id: int = 0):
        if max_context < 1 or max_draft < 1:
            raise ValueError(
                f"max_context/max_draft must be >= 1, got "
                f"{max_context}/{max_draft}")
        model.eval()
        self._model = model
        self._cap = int(max_context)
        self._k = int(max_draft)
        self._dtype = str(compute_dtype)
        self._pad = int(pad_token_id)

    @property
    def max_cache_len(self) -> int:
        """The dense cache length of every ``generate()`` call."""
        return self._cap + self._k

    def propose(self, context: np.ndarray, k: int) -> np.ndarray:
        if k < 1:
            return np.zeros((0,), np.int32)
        ctx = np.asarray(context).reshape(-1).astype(np.int32)
        ctx = ctx[-self._cap:]
        ids = np.full((1, self._cap), self._pad, np.int32)
        ids[0, :ctx.size] = ctx
        out = self._model.generate(
            ids, seq_lens=np.array([ctx.size], np.int32),
            max_new_tokens=self._k, max_cache_len=self.max_cache_len,
            compute_dtype=self._dtype)
        return out[0, :min(k, self._k)].cpu().numpy().astype(np.int32)


def accept_drafts_sampled(drafts, u_row, accept_p_row, resample_row,
                          sample_row,
                          eos_token_id: Optional[int] = None
                          ) -> Tuple[List[int], int, int]:
    """The stochastic acceptance rule (speculative sampling, one-hot
    drafts): draft j is accepted iff ``u_row[j] < accept_p_row[j]``; the
    first rejection emits the residual draw ``resample_row[j]``, and full
    acceptance emits the bonus draw ``sample_row[K]``.  An accepted EOS
    stops acceptance.  Returns ``(emitted, accepted, resamples)``, the
    last 1 when a residual draw was consumed."""
    emitted: List[int] = []
    a = 0
    while a < len(drafts) and float(u_row[a]) < float(accept_p_row[a]):
        emitted.append(int(drafts[a]))
        a += 1
        if eos_token_id is not None and emitted[-1] == eos_token_id:
            return emitted, a, 0
    if a < len(drafts):
        emitted.append(int(resample_row[a]))
        return emitted, a, 1
    emitted.append(int(sample_row[a]))
    return emitted, a, 0


def accept_drafts(greedy_row, drafts,
                  eos_token_id: Optional[int] = None
                  ) -> Tuple[List[int], int]:
    """The greedy acceptance rule: the longest draft prefix matching the
    target's own argmax, plus one correction/bonus token.

    ``greedy_row[j]`` is the target's argmax after consuming the last
    emitted token and drafts ``< j``.  Draft j is accepted iff
    ``drafts[j] == greedy_row[j]``; at the first mismatch the target's
    token is emitted instead (the correction), and when every draft
    survives the position after the last draft yields a bonus token.  An
    accepted EOS stops acceptance.  Returns ``(emitted, accepted)``."""
    emitted: List[int] = []
    a = 0
    while a < len(drafts) and int(drafts[a]) == int(greedy_row[a]):
        emitted.append(int(drafts[a]))
        a += 1
        if eos_token_id is not None and emitted[-1] == eos_token_id:
            return emitted, a
    emitted.append(int(greedy_row[a]))
    return emitted, a


def build_spec_verify(model, cfg, steps: int, kv_int8: bool = False,
                      samp_flags=(False, False, False, False),
                      lora=False, wq=None, shard=None):
    """The verifier: ONE target forward scores ``steps`` positions per
    slot (the last emitted token plus up to ``steps - 1`` draft
    candidates) against the paged arena.  The JAX package compiles this
    program; here it is a closure over ``inference/llm.py``'s
    ``spec_verify``.  ``samp_flags`` selects the output: every position's
    argmax of the processed logits (greedy mix), or with the sampled
    flag also the draws of ``sampling.spec_sampling_draws``.  A
    token-mask row never rides a verify.

    ``kv_int8`` declares the int8 cache (the arenas must match it); ``wq``
    is the weight-quant context of quantized weights or None.  Signature:
    ``(toks [B, steps], lens [B], n_valid [B], tables [B, max_blocks],
    samp, *flat_arenas) -> (greedy [B, steps][, u, accept_p, resample,
    sample], *flat_arenas)``.  ``lora=True`` inserts the ``lora`` planes
    (``{"ids": [B] int32, "a", "b"}``, ``models/lora.py``) after ``samp``:
    each spec row's draft positions are scored by ITS adapter's
    distribution, so greedy acceptance stays token-exact against that
    adapter's sequential stream."""
    if steps < 1:
        raise ValueError(f"verify steps must be >= 1, got {steps}")
    if samp_flags[3]:
        raise ValueError(
            "token-mask constrained decoding cannot ride a verify "
            "forward (mask state is host-side and per emitted token)")
    if shard is not None:
        raise NotImplementedError(
            "a sharded verify forward is not ported to paddle_tpu_torch "
            "yet (ROADMAP.md, Queue 1: sharded serving)")
    flags = tuple(bool(f) for f in samp_flags)

    def verify(toks, lens, n_valid, tables, samp, *rest):
        planes, flat_arenas = (rest[0], rest[1:]) if lora else (None, rest)
        if toks.shape[1] != steps:
            raise ValueError(f"verify built for {steps} positions got "
                             f"toks of shape {tuple(toks.shape)}")
        if (flat_arenas[0].dtype == torch.int8) != bool(kv_int8):
            raise ValueError(f"verify built with kv_int8={kv_int8} got "
                             f"{flat_arenas[0].dtype} arenas")
        return spec_verify(model, toks, lens, n_valid, tables, flat_arenas,
                           wq=wq, samp=samp, flags=flags, lora=planes)

    return verify
