"""Per-request sampling and constrained decoding of the serving engine:
port of ``paddle_tpu/inference/sampling.py``.

- ``TokenMaskProcessor`` (:84), ``DfaTokenMask`` (:115), ``SamplingParams``
  (:154) with ``validate``, ``GREEDY``, ``flags_of`` (:211) and
  ``row_planes`` (:226) are host code, copied.  ``base_key`` (:241) is
  ``threefry.prng_key``.
- ``_fold_keys`` (:248), ``process_logits`` (:256), ``categorical_rows``
  (:276), ``sample_rows`` (:288), ``sampled_decode_scan_body`` (:306, here
  ``decode_scan_step``, one step of the loop), ``_expand_spec_presence``
  (:358), ``spec_greedy_rows`` (:371) and ``spec_sampling_draws`` (:382)
  are torch ops over the JAX programs' planes: the reference traces them
  into XLA programs (no Pallas kernel), the port runs them eagerly on the
  CPU and inside the decode block's CUDA graph on the card.  Keys and
  uniforms are JAX's bits (``inference/threefry.py``).

The design is the reference's: a request's draw at output position ``i``
uses the key ``fold_in(fold_in(base, i), lane)`` (lane 0 the accept-test
uniform of speculative sampling, lane 1 the categorical draw), so a
stream depends only on ``(seed, position, lane)``; temperature, top-k,
top-p, repetition penalty and greedy-ness ride as per-row planes; the
static flags ``(sampled, filtered, penalty, bias)`` choose which planes a
program carries and what it computes, and the all-False bucket is the
greedy program: the argmax of the float32 cast of the logits.

A planes dict ``samp`` holds torch tensors on the logits' device:
``base`` [B, 2] int64 key words, ``pos`` [B] int64, ``temp`` [B] f32,
``top_k`` [B] int64, ``top_p`` [B] f32, ``greedy`` [B] bool (with the
sampled flag); ``rep`` [B] f32 and ``presence`` [B, V] bool (penalty);
``bias`` [B, V] f32 (bias).  No function here reads a tensor on the host,
indexes with a boolean mask or calls ``nonzero``: a CUDA graph capture
that met one would raise.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..models.generation import GenerationConfig, filter_top_k_top_p
from . import threefry

# temperatures below this sample like argmax anyway; such rows ARE argmax
# rows, so the scale 1/T never overflows
TEMP_EPS = 1e-4

# additive bias of banned tokens: finite, so an all-banned row's softmax
# stays defined
MASK_BIAS = -1e9

# the greedy bucket: no plane, argmax of the float32 logits
NO_FLAGS = (False, False, False, False)


class TokenMaskProcessor:
    """Host-side state machine driving token-mask constrained decoding.

    The engine calls ``begin(prompt_ids)`` once at submit, ``allowed()``
    before every decode dispatch of the request (a ``[vocab]`` bool vector
    of legal next tokens, turned into the bias plane), and
    ``advance(token)`` after each emitted token.  State is per request:
    give each request its own processor.

    Masks compose with temperature/top-k/top-p sampling and with greedy
    decoding, not with speculative decoding (the engine rejects that at
    submit).  An ``allowed()`` with no legal token means the grammar is
    complete: the engine finishes the request there, like an EOS; a dead
    start state is rejected at submit."""

    def begin(self, prompt_ids: np.ndarray) -> None:
        raise NotImplementedError

    def allowed(self) -> np.ndarray:
        raise NotImplementedError

    def advance(self, token: int) -> None:
        raise NotImplementedError


class DfaTokenMask(TokenMaskProcessor):
    """Constrained decoding over a dense DFA transition table: ``table``
    is ``[n_states, vocab]`` int32, entry ``(s, t)`` the state after
    emitting token ``t`` in state ``s`` or ``-1`` when ``t`` is illegal
    there.  The prompt does not move the DFA."""

    def __init__(self, table, start_state: int = 0):
        self.table = np.asarray(table, np.int32)
        if self.table.ndim != 2:
            raise ValueError(
                f"DFA table must be [n_states, vocab], got "
                f"{list(self.table.shape)}")
        self.start_state = int(start_state)
        if not 0 <= self.start_state < self.table.shape[0]:
            raise ValueError(
                f"start_state {start_state} outside the "
                f"{self.table.shape[0]}-state table")
        self.state = self.start_state

    def begin(self, prompt_ids: np.ndarray) -> None:
        self.state = self.start_state

    def allowed(self) -> np.ndarray:
        return self.table[self.state] >= 0

    def advance(self, token: int) -> None:
        nxt = int(self.table[self.state, int(token)])
        if nxt < 0:
            raise RuntimeError(
                f"token {token} is illegal in DFA state {self.state} — "
                f"the mask bias should have made this unreachable")
        self.state = nxt


@dataclass(frozen=True)
class SamplingParams:
    """Per-request decode configuration, carried by
    ``ServingEngine.submit(sampling=...)``.

    ``temperature=0`` (or ``top_k=1``) is greedy argmax.  ``seed`` names
    the request's PRNG stream; ``None`` derives a distinct stream per
    request (the engine seed folded with the request id).
    ``mask_processor`` plugs a host-side :class:`TokenMaskProcessor`; it
    is stateful and must not be shared between requests."""

    temperature: float = 1.0
    top_k: int = 0                    # 0 = full vocabulary
    top_p: float = 1.0                # 1.0 = off
    repetition_penalty: float = 1.0   # 1.0 = off
    seed: Optional[int] = None        # None = per-request stream
    mask_processor: Optional[TokenMaskProcessor] = field(default=None)

    @property
    def is_greedy(self) -> bool:
        """Argmax instead of a categorical draw (processors still
        apply)."""
        return self.temperature <= TEMP_EPS or self.top_k == 1

    @property
    def needs_penalty(self) -> bool:
        return self.repetition_penalty != 1.0

    def validate(self):
        if self.temperature < 0.0:
            raise ValueError(
                f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(
                f"top_p must be in (0, 1], got {self.top_p}")
        if self.repetition_penalty <= 0.0:
            raise ValueError(
                f"repetition_penalty must be > 0, got "
                f"{self.repetition_penalty}")
        if self.mask_processor is not None and \
                not isinstance(self.mask_processor, TokenMaskProcessor):
            raise ValueError(
                "mask_processor must be a TokenMaskProcessor")
        return self


GREEDY = SamplingParams(temperature=0.0)


def flags_of(params_list) -> tuple:
    """The static flag bucket of a dispatch's active mix:
    ``(sampled, filtered, penalty, bias)``.  ``filtered`` is the
    top-k/top-p sort-filter; a pure-temperature mix skips the sort."""
    ps = [p for p in params_list if p is not None]
    return (any(not p.is_greedy for p in ps),
            any(not p.is_greedy and (p.top_k > 0 or p.top_p < 1.0)
                for p in ps),
            any(p.needs_penalty for p in ps),
            any(p.mask_processor is not None for p in ps))


def row_planes(params: Optional[SamplingParams]):
    """One row's plane values ``(temp, top_k, top_p, greedy)``; greedy
    rows get neutral filter values, so the sampled branch stays finite
    for them while the ``greedy`` plane discards its draw."""
    p = params or GREEDY
    if p.is_greedy:
        return (1.0, 0, 1.0, True)
    return (max(float(p.temperature), TEMP_EPS), int(p.top_k),
            float(p.top_p), False)


def base_key(seed: int) -> np.ndarray:
    """The request's raw uint32 base key, ``PRNGKey(seed)``."""
    return threefry.prng_key(seed)


# -- device helpers (eager on the CPU, captured on the card) --

def _fold_keys(base: torch.Tensor, pos: torch.Tensor, lane: int):
    """Per-row key of output position ``pos[b]`` and ``lane``:
    ``fold_in(fold_in(base, pos), lane)``.  base [..., 2]; pos [...]."""
    return threefry.fold_in(threefry.fold_in(base, pos), lane)


def _one_hot(idx: torch.Tensor, v: int) -> torch.Tensor:
    """Bool one-hot of integer ``idx [...]`` over ``v`` classes (a
    scatter: no host check of the indices)."""
    out = torch.zeros(tuple(idx.shape) + (v,), dtype=torch.bool,
                      device=idx.device)
    return out.scatter_(-1, idx.long().unsqueeze(-1), True)


def process_logits(logits, samp, flags, presence=None):
    """The logit-processor chain before temperature: float32 cast,
    repetition penalty over the ``presence`` plane (divide positive,
    multiply negative logits), constrained-mask bias.  A row with
    ``rep == 1`` and zero bias leaves with the exact float32 cast."""
    _sampled, _filtered, penalty, bias = flags
    lg = logits.float()
    if penalty:
        rep = samp["rep"]
        rep = rep.reshape(tuple(rep.shape) + (1,) * (lg.dim() - rep.dim()))
        rep = rep.expand_as(lg)
        pen = torch.where(lg > 0, lg / rep, lg * rep)
        lg = torch.where(presence, pen, lg)
    if bias:
        lg = lg + samp["bias"]
    return lg


def categorical_rows(lg: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Per-row categorical over [..., V] logits with per-row keys
    ([..., 2]): each row's draw depends only on its own key and logits.
    Returns int32 of ``lg.shape[:-1]``."""
    return threefry.categorical(keys, lg).to(torch.int32)


def _temper(lg: torch.Tensor, temp: torch.Tensor) -> torch.Tensor:
    """``lg / temp`` per row (a division by a tensor: the card's bits
    equal the CPU's)."""
    t = temp.reshape(tuple(temp.shape) + (1,) * (lg.dim() - temp.dim()))
    return lg / t.expand_as(lg)


def sample_rows(logits, samp, flags, presence=None):
    """The full per-row chain of one decode position: process, greedy
    argmax, and (with the ``sampled`` flag) the temperature/top-k/top-p
    categorical, chosen per row by the ``greedy`` plane.  logits [B, V]
    -> tokens [B] int32; the all-False bucket is the argmax of the
    float32 cast, first index on ties."""
    sampled, filtered = flags[0], flags[1]
    lg = process_logits(logits, samp, flags, presence)
    tok_g = torch.argmax(lg, dim=-1).to(torch.int32)
    if not sampled:
        return tok_g
    keys = _fold_keys(samp["base"], samp["pos"], 1)
    lgf = _temper(lg, samp["temp"])
    if filtered:
        lgf = filter_top_k_top_p(lgf, samp["top_k"], samp["top_p"])
    tok_s = categorical_rows(lgf, keys)
    return torch.where(samp["greedy"], tok_g, tok_s)


def decode_scan_step(model, cfg: GenerationConfig, carry, samp=None,
                     flags=NO_FLAGS):
    """One step of the paged decode block with per-row sampling.

    carry = (tok, lens, kvs, pos, presence, done, budget): ``pos`` (None
    without the sampled flag) advances with emitted tokens and
    ``presence`` (None without the penalty flag) absorbs each one, so a
    multi-step block keeps both exact.  Done rows emit ``pad_token_id``
    (when an EOS is configured) and hold ``lens``, ``pos`` and their
    budget; a live row that emits EOS or whose budget reaches zero flips
    ``done``, the in-trace finish bitmap.  Returns (carry', emitted
    tokens [B] int32)."""
    sampled, penalty = flags[0], flags[2]
    tok, lens, kvs, pos, presence, done, budget = carry
    logits, kvs = model.decode_step(tok, lens, kvs)
    step_samp = samp
    if sampled:
        step_samp = dict(samp)
        step_samp["pos"] = pos
    nxt = sample_rows(logits, step_samp, flags, presence)
    if cfg.eos_token_id is not None:
        nxt = torch.where(done, torch.full_like(nxt, cfg.pad_token_id), nxt)
        done_n = done | (nxt == cfg.eos_token_id)
    else:
        done_n = done
    lens_n = torch.where(done, lens, lens + 1)
    if sampled:
        pos = torch.where(done, pos, pos + 1)
    budget_n = torch.where(done, budget, budget - 1)
    done_n = done_n | (budget_n <= 0)
    if penalty:
        presence = presence | (_one_hot(nxt, presence.shape[-1])
                               & ~done[:, None])
    return (nxt, lens_n, kvs, pos, presence, done_n, budget_n), nxt


def _expand_spec_presence(toks, presence):
    """Per-position presence planes of a verify forward: position j adds
    the draft candidates before j to the base plane (``toks[:, 0]``, the
    last emitted token, is already in it).  toks [B, C]; presence [B, V]
    -> [B, C, V]."""
    b, _c = toks.shape
    oh = _one_hot(toks[:, 1:], presence.shape[-1]).to(torch.int32)
    cum = torch.cumsum(oh, dim=1) > 0
    return presence[:, None, :] | torch.cat(
        [torch.zeros_like(cum[:, :1]), cum], dim=1)


def spec_greedy_rows(logits, toks, samp, flags, presence=None):
    """The greedy half of a verify forward: the per-position argmax of the
    processed logits (presence expanded per draft position with the
    penalty flag).  logits [B, C, V] -> [B, C] int32."""
    if flags[2]:
        presence = _expand_spec_presence(toks, presence)
    lg = process_logits(logits, samp, flags, presence)
    return torch.argmax(lg, dim=-1).to(torch.int32)


def spec_sampling_draws(logits, toks, samp, flags, presence=None):
    """Everything speculative sampling needs from one verify forward,
    drawn position-keyed.  logits [B, C, V] (position j's logits after
    drafts < j), toks [B, C] (the last emitted token, then the drafts).

    Drafts are one-hot proposals, so draft j is accepted with probability
    ``p_j(d_j)`` and the residual is ``p_j`` with ``d_j`` masked out.
    Returns ``(greedy [B, C] int32, u [B, C] f32 (lane 0 of position pos
    + j), accept_p [B, C] f32 (column C-1 reads 0), resample [B, C] int32
    (the residual draw), sample [B, C] int32 (a draw from p_j))``;
    ``resample`` and ``sample`` share lane 1 of position pos + j, so they
    share the Gumbel noise."""
    b, c, v = logits.shape
    if flags[2]:
        presence = _expand_spec_presence(toks, presence)
    lg = process_logits(logits, samp, flags, presence)
    greedy = torch.argmax(lg, dim=-1).to(torch.int32)
    pos = samp["pos"][:, None] + torch.arange(
        c, dtype=samp["pos"].dtype, device=lg.device)[None, :]
    base = samp["base"][:, None, :].expand(b, c, 2)
    u = threefry.uniform(_fold_keys(base, pos, 0))
    s_keys = _fold_keys(base, pos, 1)
    lgf = _temper(lg, samp["temp"])
    if flags[1]:
        lgf = filter_top_k_top_p(lgf, samp["top_k"][:, None].expand(b, c),
                                 samp["top_p"][:, None].expand(b, c))
    probs = torch.softmax(lgf, dim=-1)
    # the draft at position j is the next input token; the last column
    # has no draft (its draws serve only the bonus sample)
    d = torch.cat([toks[:, 1:].long(),
                   torch.zeros_like(toks[:, :1], dtype=torch.long)], dim=1)
    accept_p = torch.gather(probs, -1, d[..., None])[..., 0]
    accept_p = torch.cat([accept_p[:, :-1],
                          torch.zeros_like(accept_p[:, -1:])], dim=1)
    lg_res = torch.where(_one_hot(d, v), float("-inf"), lgf)
    g = threefry.gumbel(s_keys, (v,))
    resample = torch.argmax(g + lg_res, dim=-1).to(torch.int32)
    sample = torch.argmax(g + lgf, dim=-1).to(torch.int32)
    return greedy, u, accept_p, resample, sample
