"""The keying of ``generate()``'s captured programs, held on the CPU with a
stand-in for the graph (a CUDA graph needs the card, where
``chip_smoke.py`` phase 3h holds each replay bit-equal to the eager
program with the eager call's launches):

- one entry per (B, prompt length, max_cache_len, ``GenerationConfig``,
  parameter structure), the reference's program key; the config is
  hashable and carries ``max_new_tokens``, ``num_beams`` and
  ``length_penalty``;
- a rebinding of a parameter (``p.data = ...``, a cast) changes the
  structure: the call misses and the stale entry is evicted; an in-place
  ``load_state_dict`` keeps the entry;
- a CPU model runs the eager program and captures nothing; a graph of a
  CPU model is refused.
"""

import dataclasses

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference import llm
from paddle_tpu_torch.models import (GenerationConfig, LlamaForCausalLM,
                                     tiny_llama_config)
from paddle_tpu_torch.models.generation import parameter_structure


class _StandIn:
    """Records what a GenerateGraph would have been built for."""
    made = []

    def __init__(self, model, cfg, b, s, max_cache_len):
        self.key = (b, s, max_cache_len, cfg)
        _StandIn.made.append(self.key)


@pytest.fixture
def net(monkeypatch):
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(llm, "GenerateGraph", _StandIn)
    _StandIn.made = []
    yield LlamaForCausalLM(tiny_llama_config(), device="cpu", seed=4)
    torch.set_num_threads(prev)


def test_config_is_the_reference_key():
    fields = [f.name for f in dataclasses.fields(GenerationConfig)]
    assert fields == ["max_new_tokens", "do_sample", "temperature", "top_k",
                      "top_p", "num_beams", "length_penalty", "eos_token_id",
                      "pad_token_id", "compute_dtype", "cache_dtype"]
    a = GenerationConfig(max_new_tokens=4, num_beams=2, length_penalty=1.0)
    assert hash(a) == hash(dataclasses.replace(a))
    assert a != dataclasses.replace(a, num_beams=3)


def test_one_entry_per_key(net):
    cfg = GenerationConfig(max_new_tokens=4)
    g = net._generate_graph(2, 6, 16, cfg)
    assert net._generate_graph(2, 6, 16, cfg) is g
    assert net._generate_graph(2, 6, 16, GenerationConfig(
        max_new_tokens=4)) is g
    for other in ((1, 6, 16, cfg), (2, 7, 16, cfg), (2, 6, 17, cfg),
                  (2, 6, 16, dataclasses.replace(cfg, num_beams=2))):
        assert net._generate_graph(*other) is not g
    assert len(_StandIn.made) == 5
    assert len(net._generate_graphs) == 5


def test_rebinding_evicts_and_load_state_dict_keeps(net):
    cfg = GenerationConfig(max_new_tokens=3)
    g = net._generate_graph(1, 4, 8, cfg)
    before = parameter_structure(net)
    net.load_state_dict({k: v.clone() for k, v in net.state_dict().items()})
    assert parameter_structure(net) == before
    assert net._generate_graph(1, 4, 8, cfg) is g
    p = net.lm_head.weight
    p.data = p.data.clone()
    assert parameter_structure(net) != before
    g2 = net._generate_graph(1, 4, 8, cfg)
    assert g2 is not g and list(net._generate_graphs.values()) == [g2]
    net.to(torch.float64)
    g3 = net._generate_graph(1, 4, 8, cfg)
    assert g3 is not g2 and len(net._generate_graphs) == 1


def test_cpu_model_runs_eagerly(net):
    ids = np.arange(8, dtype=np.int32).reshape(2, 4)
    for kw in ({}, {"num_beams": 2}, {"do_sample": True, "top_k": 3}):
        out = net.generate(ids, max_new_tokens=3, compute_dtype="float32",
                           **kw)
        assert out.shape == (2, 3) and out.dtype == torch.int32
    assert _StandIn.made == []
    assert "_generate_graphs" not in net.__dict__
    pred = llm.LLMPredictor(net, batch=2, prompt_len=4, max_cache_len=8,
                            compute_dtype="float32")
    assert not hasattr(pred, "_block_graph")


def test_graph_of_a_cpu_model_is_refused():
    net = LlamaForCausalLM(tiny_llama_config(), device="cpu", seed=4)
    with pytest.raises(ValueError, match="CUDA"):
        llm.GenerateGraph(net, GenerationConfig(), 1, 4, 8)
