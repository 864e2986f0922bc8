"""Seq2seq decoding: port of ``paddle_tpu/nn/decode.py``.

``Decoder`` (:52) is the step interface ``dynamic_decode`` drives.
``BeamSearchDecoder`` (:71) runs beam search over any cell
``cell(inputs, states) -> (outputs, next_states)`` whose states are a
nest of tensors, batch first: the batch is tiled to ``[B * K]``, beam 0
starts at score 0 and the others at -1e9 (so the first step picks K
distinct tokens), a finished beam continues only with ``end_token`` at
zero cost, the next beams are the top K of the ``K * V`` scores (ties
to the lower flat index, as ``lax.top_k``), and the cell states,
finished flags and lengths are gathered by the chosen parents.
``finalize`` backtraces with ``nn.functional.gather_tree``.
``dynamic_decode`` (:202) steps until every entry is finished or the
step count passes ``max_step_num`` (the reference's ``step > limit``),
with ``impute_finished``, ``output_time_major`` and ``return_length``;
its one host read a step (``finished.all()``) is the reference's
contract.  Every tensor stays on the cell's device.
"""

from __future__ import annotations

import collections

import torch
from torch.utils import _pytree as pytree

__all__ = ["Decoder", "BeamSearchDecoder", "dynamic_decode"]

_NEG_INF = 1e9


def _map(fn, nest):
    return pytree.tree_map(fn, nest)


class Decoder:
    """``initialize`` -> repeated ``step`` -> optional ``finalize``."""

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states, **kwargs):
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        raise NotImplementedError

    @property
    def tracks_own_finished(self):
        return False


class BeamSearchDecoder(Decoder):
    OutputWrapper = collections.namedtuple(
        "OutputWrapper", ("scores", "predicted_ids", "parent_ids"))
    StateWrapper = collections.namedtuple(
        "StateWrapper", ("cell_states", "log_probs", "finished", "lengths"))

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """[B, ...] -> [B * beam, ...], each entry repeated beam times."""
        return torch.repeat_interleave(x, beam_size, dim=0)

    def _split_batch_beams(self, v):
        return v.reshape((-1, self.beam_size) + tuple(v.shape[1:]))

    def _merge_batch_beams(self, v):
        return v.reshape((-1,) + tuple(v.shape[2:]))

    def _expand_to_beam_size(self, v):
        return torch.repeat_interleave(v[:, None], self.beam_size, dim=1)

    def _gather(self, v, beam_indices):
        """Reorder the beam axis of ``v [B, K, ...]`` by ``beam_indices
        [B, K]``."""
        rows = torch.arange(v.shape[0], device=v.device)[:, None]
        return v[rows, beam_indices]

    def initialize(self, initial_cell_states):
        cell_states = _map(self._expand_to_beam_size, initial_cell_states)
        first = pytree.tree_leaves(cell_states)[0]
        batch, dev, k = first.shape[0], first.device, self.beam_size
        init_inputs = torch.full((batch, k), self.start_token,
                                 dtype=torch.int32, device=dev)
        log_probs = torch.tensor([[0.0] + [-_NEG_INF] * (k - 1)],
                                 dtype=torch.float32,
                                 device=dev).repeat(batch, 1)
        finished = torch.zeros((batch, k), dtype=torch.bool, device=dev)
        lengths = torch.zeros((batch, k), dtype=torch.int32, device=dev)
        states = self.StateWrapper(cell_states, log_probs, finished, lengths)
        inputs = (self.embedding_fn(init_inputs) if self.embedding_fn
                  else init_inputs)
        return inputs, states, finished

    def _beam_search_step(self, time, logits, next_cell_states, beam_state):
        """Score the candidates and pick the next beams; logits
        ``[B, K, V]``."""
        b, k, vocab = logits.shape
        step_lp = torch.log_softmax(logits.float(), dim=-1)
        # finished beams may only continue with end_token at zero cost
        # (an end_token outside [-V, V) is dropped, as JAX drops the
        # out-of-bounds update)
        noend = torch.full((vocab,), -_NEG_INF, dtype=torch.float32,
                           device=logits.device)
        if -vocab <= self.end_token < vocab:
            noend[self.end_token] = 0.0
        step_lp = torch.where(beam_state.finished[:, :, None],
                              noend[None, None, :], step_lp)
        total = beam_state.log_probs[:, :, None] + step_lp
        flat = total.reshape(b, k * vocab)
        order = torch.sort(flat, dim=-1, descending=True, stable=True)
        topk_scores, topk_idx = order.values[:, :k], order.indices[:, :k]
        beam_idx = topk_idx // vocab
        token_idx = (topk_idx % vocab).to(torch.int32)
        next_cell_states = _map(lambda v: self._gather(v, beam_idx),
                                next_cell_states)
        prev_finished = self._gather(beam_state.finished, beam_idx)
        lengths = self._gather(beam_state.lengths, beam_idx)
        lengths = lengths + (~prev_finished).to(torch.int32)
        finished = prev_finished | (token_idx == self.end_token)
        out = self.OutputWrapper(topk_scores, token_idx,
                                 beam_idx.to(torch.int32))
        state = self.StateWrapper(next_cell_states, topk_scores, finished,
                                  lengths)
        return out, state

    def step(self, time, inputs, states, **kwargs):
        merged_inputs = _map(self._merge_batch_beams, inputs)
        merged_cell_states = _map(self._merge_batch_beams,
                                  states.cell_states)
        cell_out, next_cell_states = self.cell(merged_inputs,
                                               merged_cell_states, **kwargs)
        if self.output_fn is not None:
            cell_out = self.output_fn(cell_out)
        logits = self._split_batch_beams(cell_out)
        next_cell_states = _map(self._split_batch_beams, next_cell_states)
        out, state = self._beam_search_step(time, logits, next_cell_states,
                                            states)
        sample_ids = out.predicted_ids
        next_inputs = (self.embedding_fn(sample_ids) if self.embedding_fn
                       else sample_ids)
        return out, state, next_inputs, state.finished

    def finalize(self, outputs, final_states, sequence_lengths):
        """Backtrace the beam tree into full sequences ``[T, B, K]``."""
        from .functional import gather_tree
        return gather_tree(outputs.predicted_ids,
                           outputs.parent_ids), final_states

    @property
    def tracks_own_finished(self):
        return True


def dynamic_decode(decoder, inits=None, max_step_num=None,
                   output_time_major=False, impute_finished=False,
                   is_test=False, return_length=False, **kwargs):
    """Run ``decoder.step`` until every sequence finishes or the step
    count passes ``max_step_num``; returns ``(outputs, final_states)``
    (and the lengths with ``return_length``), outputs batch-major unless
    ``output_time_major``."""
    inputs, states, finished = decoder.initialize(inits)
    finished_v = finished.bool()
    seq_lens = torch.zeros(finished_v.shape, dtype=torch.int32,
                           device=finished_v.device)
    step_outputs = []
    step = 0
    limit = int(max_step_num) if max_step_num is not None else 10 ** 9

    while True:
        time = torch.tensor([step], dtype=torch.int32,
                            device=finished_v.device)
        out, next_states, next_inputs, next_finished = decoder.step(
            time, inputs, states, **kwargs)
        next_finished_v = next_finished.bool()
        if not decoder.tracks_own_finished:
            next_finished_v = next_finished_v | finished_v
            if impute_finished:
                # copy states through for entries already finished; a
                # decoder that tracks its own finished (beam search)
                # reorders its states itself (reference decode.py:734)
                def _impute(new, old, done=finished_v):
                    mask = done.reshape(done.shape
                                        + (1,) * (new.ndim - done.ndim))
                    return torch.where(mask, old, new)
                next_states = pytree.tree_map(_impute, next_states, states)
            seq_lens = seq_lens + (~finished_v).to(torch.int32)
        else:
            # the decoder's own state carries the lengths
            seq_lens = getattr(next_states, "lengths", seq_lens)
        step_outputs.append(out)
        inputs, states, finished_v = next_inputs, next_states, \
            next_finished_v
        step += 1
        if step > limit or bool(next_finished_v.all()):
            break

    stacked = pytree.tree_map(lambda *xs: torch.stack(xs, dim=0),
                              step_outputs[0], *step_outputs[1:])
    final_outputs, final_states = stacked, states
    if not isinstance(getattr(type(decoder), "finalize", None), property):
        try:
            final_outputs, final_states = decoder.finalize(
                stacked, states, seq_lens)
        except NotImplementedError:
            pass
    if not output_time_major:
        final_outputs = _map(
            lambda v: v.transpose(0, 1) if v.ndim >= 2 else v,
            final_outputs)
    if return_length:
        return final_outputs, final_states, seq_lens
    return final_outputs, final_states
