"""The train step's instruments and spans of the port held against the
JAX package's on the CPU: the five ``train_step.*`` instruments' names,
kinds, help strings and buckets, their counts after the same sequence of
``TrainStep`` calls and ``run_steps`` (a "compile" is the first dispatch
of a (TrainStep, block size) pair), and the spans each call records.
Counts and span names are compared exactly.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu import runtime as jrt
from paddle_tpu.jit import train_step as jts
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.observability.spans import parse_span_name as jparse
from paddle_tpu_torch import runtime as trt
from paddle_tpu_torch.jit import train_step as tts
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_state_from_jax,
                                     tiny_llama_config)
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.observability.spans import parse_span_name as tparse
from paddle_tpu_torch.optimizer import SGD

NAMES = ("train_step.compiles", "train_step.compile_seconds",
         "train_step.cache_hits", "train_step.cache_misses",
         "train_step.step_seconds")
# (call, block size): three plain calls, then run_steps of 2, 2 and 3
SEQUENCE = [("call", 1)] * 3 + [("run", 2), ("run", 2), ("run", 3)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _counts(registry):
    out = {}
    for name in NAMES:
        inst = registry.get(name)
        if inst is None:
            out[name] = 0
        elif hasattr(inst, "summary"):
            out[name] = inst.summary()["count"]
        else:
            out[name] = inst.total()
    return out


@pytest.fixture(scope="module")
def driven():
    paddle.seed(3)
    jnet = jmodels.LlamaForCausalLM(jmodels.tiny_llama_config())
    jnet.train()
    arrays = {n: np.array(p._value, copy=True)
              for n, p in jnet.named_parameters()}
    tnet = LlamaForCausalLM(tiny_llama_config(), device="cpu", init=False)
    tnet.load_state_dict(llama_state_from_jax(arrays), strict=True)
    tnet.train()
    tokens = np.random.default_rng(1).integers(0, 256, (2, 16)).astype(
        np.int32)
    jstep = jts.TrainStep(jnet, lambda n, t: n(t, labels=t)[0],
                          paddle.optimizer.SGD(0.01,
                                               parameters=jnet.parameters()))
    tstep = tts.TrainStep(tnet, lambda n, t: n(t, labels=t)[0],
                          SGD(0.01, parameters=tnet.parameters()))
    out = {}
    for side, step, registry, rt, inst_cls in (
            ("j", jstep, jmetrics.get_registry(), jrt, jts._TrainStepInstruments),
            ("t", tstep, tmetrics.get_registry(), trt,
             tts._TrainStepInstruments)):
        inst_cls.get()                     # the instruments exist
        before = _counts(registry)
        rt.HostTracer.clear()
        rt.HostTracer.enable()
        try:
            for how, block in SEQUENCE:
                t = paddle.to_tensor(tokens) if side == "j" else tokens
                if how == "call":
                    step(t)
                else:
                    step.run_steps(t, steps=block)
            events = rt.HostTracer.events()
        finally:
            rt.HostTracer.disable()
            rt.HostTracer.clear()
        after = _counts(registry)
        out[side] = dict(delta={k: after[k] - before[k] for k in NAMES},
                         registry=registry,
                         events=[e[5] for e in events if e[0] == 0])
    return out


def test_instrument_names_help_and_buckets_match_jax(driven):
    jreg, treg = driven["j"]["registry"], driven["t"]["registry"]
    for name in NAMES:
        j, t = jreg.get(name), treg.get(name)
        assert type(t).__name__ == type(j).__name__, name
        assert t.help == j.help, name
        assert getattr(t, "buckets", None) == getattr(j, "buckets", None)


def test_counts_after_calls_and_run_steps_match_jax(driven):
    want = driven["j"]["delta"]
    assert driven["t"]["delta"] == want
    assert want == {"train_step.compiles": 3, "train_step.compile_seconds": 3,
                    "train_step.cache_hits": 3, "train_step.cache_misses": 3,
                    "train_step.step_seconds": 3}


def test_spans_match_jax(driven):
    jnames = [jparse(n) for n in driven["j"]["events"]
              if n.startswith("train_step.")]
    tnames = [tparse(n) for n in driven["t"]["events"]
              if n.startswith("train_step.")]
    assert tnames == jnames
    assert [n for n, _ in tnames].count("train_step.call") == 3
    assert ("train_step.run_steps", {"steps": "3"}) in tnames
