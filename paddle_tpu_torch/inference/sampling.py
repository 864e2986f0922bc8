"""Greedy token selection of the serving path: port of the all-False
(argmax-only) build of ``paddle_tpu/inference/sampling.py`` —
``sample_rows`` (:288), the per-step body of ``sampled_decode_scan_body``
(:306-355) and ``spec_greedy_rows`` (:371, the verify forward's
per-position argmax).  Sampling, penalties and token masks are not ported
yet (ROADMAP.md, Queue 1: sampling and speculation)."""

from __future__ import annotations

import torch

from ..models.generation import GenerationConfig


def sample_rows(logits: torch.Tensor) -> torch.Tensor:
    """Greedy row choice: the f32 cast of the logits (the JAX logit
    processor chain with no penalty and no bias), then argmax — the
    first index on ties, like ``jnp.argmax``.  logits [B, V] -> [B]
    int32."""
    return torch.argmax(logits.float(), dim=-1).to(torch.int32)


def spec_greedy_rows(logits: torch.Tensor) -> torch.Tensor:
    """The greedy half of a verify forward: the per-position argmax of
    the f32 cast of the logits (``process_logits`` with every flag off),
    first index on ties.  logits [B, C, V] -> [B, C] int32."""
    return sample_rows(logits)


def decode_scan_step(model, cfg: GenerationConfig, carry):
    """One step of the greedy paged decode scan.

    carry = (tok, lens, kvs, done, budget), all [B] except the kvs list.
    Done rows emit ``pad_token_id`` (when an EOS is configured), hold
    their ``lens`` and their budget; a live row that emits EOS or whose
    budget reaches zero flips ``done`` — the in-trace finish bitmap.
    Returns (carry', emitted tokens [B] int32)."""
    tok, lens, kvs, done, budget = carry
    logits, kvs = model.decode_step(tok, lens, kvs)
    nxt = sample_rows(logits)
    if cfg.eos_token_id is not None:
        nxt = torch.where(done, torch.full_like(nxt, cfg.pad_token_id), nxt)
        done_n = done | (nxt == cfg.eos_token_id)
    else:
        done_n = done
    lens_n = torch.where(done, lens, lens + 1)
    budget_n = torch.where(done, budget, budget - 1)
    done_n = done_n | (budget_n <= 0)
    return (nxt, lens_n, kvs, done_n, budget_n), nxt
