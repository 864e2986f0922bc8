"""``weight_only_quantize`` on the port's Llama and GPT held against the
JAX package's on the CPU, on bridged weights (float32, tiny models):

- the converted buffers (``qweight [in, out]`` int8, ``weight_scale``
  float32) equal the JAX conversion's bit for bit, with and without
  ``skip`` (a converted ``lm_head`` serves too); logits within ``1e-5``
  under both values of ``FLAGS_use_int8_matmul_kernel``;
- ``LLMPredictor`` and ``generate()`` tokens of the converted models
  equal the JAX package's up to each row's first non-decisive position
  (teacher-forced top-2 margin of the JAX logits above 0.01); GPT with
  random projection biases;
- ``inplace=False`` leaves the source model and its captured
  ``generate()`` graphs intact and copies no graph; an in-place
  conversion clears them (the reference's
  ``test_quantize_invalidates_generate_cache``); a model without a
  Linear raises the reference's ``ValueError`` word for word;
- the flag is read at every call and is part of a converted model's
  ``generate()`` program key (a toggle misses), not of a float model's;
  a converted session decodes on the route it was started on, a float
  one ignores the flag; ``ServingEngine`` refuses a converted model; the
  artifact of a converted session rebuilds its int8 layers;
- step 4 of the ``llama_serve`` twin equals ``examples/llama_serve.py``'s
  step 4 on the same weights, in the example's bfloat16, up to each
  row's first position whose top-2 margin is within ``BF16_ULPS`` bf16
  ulps of the top logit (the two packages round their bf16 products in
  other orders).
"""

import copy

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu.inference import LLMPredictor as JaxPredictor
from paddle_tpu.quantization import weight_only_quantize as j_woq
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.core.flags import get_flags, set_flags
from paddle_tpu_torch.inference import llm
from paddle_tpu_torch.inference.llm import ARTIFACT_SUFFIX, LLMPredictor
from paddle_tpu_torch.models import (GenerationConfig, GPTForCausalLM,
                                     LlamaForCausalLM, gpt_state_from_jax,
                                     llama_state_from_jax, tiny_gpt_config,
                                     tiny_llama_config)
from paddle_tpu_torch.nn.quant import QuantizedLinearInfer
from paddle_tpu_torch.quantization import weight_only_quantize

MARGIN = 0.01
BF16_ULPS = 4
FLAG = "FLAGS_use_int8_matmul_kernel"


def _skip_head(name, layer):
    return name == "lm_head"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def kernel_flag():
    yield lambda on: set_flags({FLAG: on})
    set_flags({FLAG: False})


def _jax_buffers(jnet):
    return {n: np.asarray(b._value) for n, b in jnet.named_buffers()}


@pytest.fixture(scope="module")
def llama():
    paddle.seed(2024)
    jnet = jmodels.LlamaForCausalLM(jmodels.tiny_llama_config())
    jnet.eval()
    arrays = {n: np.asarray(p._value) for n, p in jnet.named_parameters()}
    tnet = LlamaForCausalLM(tiny_llama_config(), device="cpu", init=False)
    tnet.load_state_dict(llama_state_from_jax(arrays))
    return jnet, tnet


@pytest.fixture(scope="module")
def gpt():
    """A tiny GPT whose projection biases are random (the reference's
    initial biases are zero, which would leave the bias path unseen)."""
    import jax.numpy as jnp
    paddle.seed(7)
    jnet = jmodels.GPTForCausalLM(jmodels.tiny_gpt_config())
    jnet.eval()
    rng = np.random.default_rng(7)
    for name, p in jnet.named_parameters():
        if name.endswith(".bias") and ("proj" in name or "fc_" in name):
            p.set_value(jnp.asarray(
                0.1 * rng.standard_normal(p.shape).astype(np.float32)))
    arrays = {n: np.asarray(p._value) for n, p in jnet.named_parameters()}
    tnet = GPTForCausalLM(tiny_gpt_config(), device="cpu", init=False)
    tnet.load_state_dict(gpt_state_from_jax(arrays), strict=True)
    return jnet, tnet


@pytest.fixture(scope="module")
def converted(llama, gpt):
    """Both packages' conversions (``inplace=False``) of both models, with
    and without ``skip``."""
    out = {}
    for fam, (jnet, tnet) in (("llama", llama), ("gpt", gpt)):
        for skip in (True, False):
            kw = {"skip": _skip_head} if skip else {}
            out[fam, skip] = (j_woq(jnet, inplace=False, **kw),
                              weight_only_quantize(tnet, inplace=False,
                                                   **kw))
    return out


def _ids(seed, b, p, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, p)).astype(
        np.int32)


def _upto(lg, tol):
    """The first position whose top-2 margin is within ``tol`` (an array
    or a number), or the row's length."""
    top2 = np.sort(lg, axis=-1)[:, -2:]
    close = np.flatnonzero(top2[:, 1] - top2[:, 0] <= tol)
    return int(close[0]) if close.size else len(lg)


def _jax_forced(jnet, prompt, out):
    """Teacher-forced float32 logits of the JAX model that predict
    ``out`` after ``prompt``."""
    s = np.concatenate([prompt, out[:-1]])[None].astype(np.int32)
    lg = np.asarray(jnet(paddle.to_tensor(s))._value)[0]
    return lg[len(prompt) - 1:len(prompt) - 1 + len(out)]


def _hold_rows(jnet, prompts, got, want, tol=MARGIN):
    """``got`` equals ``want`` up to each row's first non-decisive
    position; at least half of all positions are compared."""
    compared = total = 0
    for p, g, w in zip(prompts, got, want):
        lg = _jax_forced(jnet, p, np.asarray(w, np.int32))
        upto = _upto(lg, tol)
        np.testing.assert_array_equal(np.asarray(g)[:upto],
                                      np.asarray(w)[:upto])
        compared += upto
        total += len(w)
    assert total and compared >= 0.5 * total, (compared, total)


@pytest.mark.parametrize("fam", ["llama", "gpt"])
@pytest.mark.parametrize("skip", [True, False])
def test_buffers_bit_equal_and_logits(converted, fam, skip, kernel_flag):
    qj, qt = converted[fam, skip]
    jb = _jax_buffers(qj)
    tb = dict(qt.named_buffers())
    assert set(tb) == set(jb) and tb
    for name, t in tb.items():
        want = jb[name]
        assert str(t.dtype).endswith(str(want.dtype)), name
        np.testing.assert_array_equal(t.numpy(), want, err_msg=name)
    heads = [n for n in tb if n.startswith("lm_head.")]
    assert bool(heads) == (not skip)
    assert isinstance(qt.lm_head, QuantizedLinearInfer) == (not skip)
    n_lin = sum(isinstance(m, torch.nn.Linear) for m in qt.modules())
    assert n_lin == (1 if skip else 0)
    ids = _ids(3, 2, 9)
    want = np.asarray(qj(paddle.to_tensor(ids))._value)
    for on in (False, True):
        kernel_flag(on)
        got = qt(torch.from_numpy(ids)).detach().numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0,
                                   err_msg=f"kernel={on}")


@pytest.mark.parametrize("fam", ["llama", "gpt"])
@pytest.mark.parametrize("skip", [True, False])
def test_session_and_generate_match_jax(converted, fam, skip):
    qj, qt = converted[fam, skip]
    ids = _ids(12, 2, 6)        # every position decisive in all four
    kw = dict(batch=2, prompt_len=6, max_cache_len=24, steps_per_call=4,
              compute_dtype="float32")
    want = JaxPredictor(qj, **kw).generate(ids.copy(), max_new_tokens=9)
    got = LLMPredictor(qt, **kw).generate(ids, max_new_tokens=9)
    _hold_rows(qj, ids, got, want)
    gen = qt.generate(ids, max_new_tokens=9, max_cache_len=24,
                      compute_dtype="float32").numpy()
    np.testing.assert_array_equal(gen, got)


def test_buffers_are_never_cast(converted):
    """A bf16 ``generate()`` of a float32 converted model casts the
    parameters for the call only and never the buffers: int8 codes stay
    int8 and scales float32, bit for bit."""
    _qj, qt = converted["gpt", False]
    before = {n: b.clone() for n, b in qt.named_buffers()}
    out = qt.generate(_ids(5, 1, 4), max_new_tokens=3,
                      compute_dtype="bfloat16")
    assert out.shape == (1, 3)
    for n, b in qt.named_buffers():
        assert b.dtype == before[n].dtype and torch.equal(b, before[n]), n
    assert all(p.dtype == torch.float32 for p in qt.parameters())


class _Graph:
    """Stands in for a captured generate() graph on the CPU; a graph must
    never be deep-copied."""
    made = []

    def __init__(self, model, cfg, b, s, max_cache_len):
        _Graph.made.append((b, s, max_cache_len, cfg))

    def __deepcopy__(self, memo):
        raise AssertionError("a captured graph was deep-copied")


@pytest.fixture
def standin(monkeypatch):
    monkeypatch.setattr(llm, "GenerateGraph", _Graph)
    _Graph.made = []
    yield
    set_flags({FLAG: False})


def test_inplace_false_keeps_the_source_and_its_graphs(llama, standin):
    _jnet, tnet = llama
    src = copy.deepcopy(tnet)
    g = src._generate_graph(1, 4, 8, GenerationConfig(max_new_tokens=3))
    before = {n: p.clone() for n, p in src.state_dict().items()}
    q = weight_only_quantize(src, inplace=False, skip=_skip_head)
    assert src._generate_graphs and list(src._generate_graphs.values()) == \
        [g]
    assert "_generate_graphs" not in q.__dict__
    assert isinstance(src.llama.layers[0].self_attn.q_proj, torch.nn.Linear)
    for n, p in src.state_dict().items():
        assert torch.equal(p, before[n]), n
    assert isinstance(q.llama.layers[0].self_attn.q_proj,
                      QuantizedLinearInfer)


def test_quantize_invalidates_generate_cache(llama, standin):
    _jnet, tnet = llama
    net = copy.deepcopy(tnet)
    cfg = GenerationConfig(max_new_tokens=3)
    net._generate_graph(1, 4, 8, cfg)
    assert len(net._generate_graphs) == 1
    out = weight_only_quantize(net)
    assert out is net and net._generate_graphs == {}
    net._generate_graph(1, 4, 8, cfg)
    assert len(_Graph.made) == 2


def test_flag_is_in_the_program_key(llama, standin):
    _jnet, tnet = llama
    net = copy.deepcopy(tnet)
    weight_only_quantize(net)
    cfg = GenerationConfig(max_new_tokens=3)
    off = net._generate_graph(1, 4, 8, cfg)
    set_flags({FLAG: True})
    on = net._generate_graph(1, 4, 8, cfg)
    assert on is not off and len(net._generate_graphs) == 2
    assert net._generate_graph(1, 4, 8, cfg) is on
    set_flags({FLAG: False})
    assert net._generate_graph(1, 4, 8, cfg) is off


def test_float_model_key_ignores_the_flag(llama, standin):
    """A float model has one route: its program key holds no flag, so a
    toggle hits the graph it has."""
    _jnet, tnet = llama
    net = copy.deepcopy(tnet)
    cfg = GenerationConfig(max_new_tokens=3)
    g = net._generate_graph(1, 4, 8, cfg)
    set_flags({FLAG: True})
    assert net._generate_graph(1, 4, 8, cfg) is g
    assert len(net._generate_graphs) == 1 and len(_Graph.made) == 1


def test_float_session_ignores_the_flag(llama, kernel_flag):
    """A float model's session does not read the flag: a toggle between
    ``start()`` and ``decode()`` neither raises nor changes a token."""
    _jnet, tnet = llama
    ids = _ids(17, 2, 5)
    kw = dict(batch=2, prompt_len=5, max_cache_len=20, steps_per_call=4,
              compute_dtype="float32")
    pred = LLMPredictor(tnet, **kw)
    first = pred.start(ids)
    kernel_flag(True)
    got = np.concatenate([first[:, None], pred.decode(7)], axis=1)
    kernel_flag(False)
    np.testing.assert_array_equal(
        got, LLMPredictor(tnet, **kw).generate(ids, max_new_tokens=8))


@pytest.mark.parametrize("where", ["model", "drafter"])
def test_engine_refuses_a_converted_model(llama, converted, where):
    """The engine's captured decode graphs would record one route of the
    flag and its cast to ``compute_dtype`` would cast the float32
    scales: a converted model (or drafter model) is refused, naming the
    Known differences section."""
    from paddle_tpu_torch.inference import ModelDrafter, ServingEngine
    _jnet, tnet = llama
    _qj, qt = converted["llama", True]
    kw = dict(num_slots=2, prompt_len=8, compute_dtype="float32",
              device="cpu")
    if where == "model":
        args = (qt,)
    else:
        args = (copy.deepcopy(tnet),)
        kw["drafter"] = ModelDrafter(qt, max_context=8)
    with pytest.raises(NotImplementedError,
                       match="Known differences of quantization"):
        ServingEngine(*args, **kw)
    assert all(b.dtype in (torch.int8, torch.float32)
               for b in qt.buffers())


def test_no_linear_raises_the_reference_error():
    class NoLinear(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.norm = tnn.LayerNorm(4, device="cpu")

    with pytest.raises(ValueError) as tv:
        weight_only_quantize(NoLinear())
    import paddle_tpu.nn as jnn
    with pytest.raises(ValueError) as jv:
        j_woq(jnn.Sequential(jnn.LayerNorm(4)))
    assert str(tv.value) == str(jv.value)
    assert "converted no layers" in str(tv.value)


def test_flag_on_against_off(converted, kernel_flag):
    """Float32: the kernel's plain version (codes x in float32, then the
    scale) against the dequantized product, within ``1e-5``; greedy
    tokens equal at decisive positions."""
    assert get_flags(FLAG) == {FLAG: False}
    qj, qt = converted["llama", False]
    ids = _ids(13, 2, 7)
    off = qt(torch.from_numpy(ids)).detach().numpy()
    g_off = qt.generate(ids, max_new_tokens=8,
                        compute_dtype="float32").numpy()
    kernel_flag(True)
    on = qt(torch.from_numpy(ids)).detach().numpy()
    g_on = qt.generate(ids, max_new_tokens=8,
                       compute_dtype="float32").numpy()
    np.testing.assert_allclose(on, off, atol=1e-5, rtol=0)
    assert not np.array_equal(on, off)       # two routes, two roundings
    _hold_rows(qj, ids, g_on, g_off)


def test_session_decodes_on_its_start_route(converted, kernel_flag):
    _qj, qt = converted["llama", True]
    ids = _ids(17, 2, 5)
    pred = LLMPredictor(qt, batch=2, prompt_len=5, max_cache_len=20,
                        steps_per_call=4, compute_dtype="float32")
    pred.start(ids)
    kernel_flag(True)
    with pytest.raises(RuntimeError, match="Known differences of "
                                           "quantization"):
        pred.decode(4)
    first = pred.start(ids)
    on = np.concatenate([first[:, None], pred.decode(7)], axis=1)
    kw = dict(batch=2, prompt_len=5, max_cache_len=20, steps_per_call=4,
              compute_dtype="float32")
    np.testing.assert_array_equal(
        on, LLMPredictor(qt, **kw).generate(ids, max_new_tokens=8))
    kernel_flag(False)
    np.testing.assert_array_equal(
        pred.generate(ids, max_new_tokens=8),
        LLMPredictor(qt, **kw).generate(ids, max_new_tokens=8))


def test_artifact_of_a_converted_session(converted, tmp_path):
    import pickle
    for fam in ("llama", "gpt"):
        _qj, qt = converted[fam, True]
        ids = _ids(19, 2, 4)
        pred = LLMPredictor(qt, batch=2, prompt_len=4, max_cache_len=16,
                            steps_per_call=4, compute_dtype="float32")
        want = pred.generate(ids, max_new_tokens=8)
        path = str(tmp_path / fam)
        pred.save(path)
        with open(path + ARTIFACT_SUFFIX, "rb") as f:
            blob = pickle.load(f)
        names = {n for n, m in qt.named_modules()
                 if isinstance(m, QuantizedLinearInfer)}
        assert set(blob["quantized"]) == names
        assert blob["weights"][next(iter(names)) + ".qweight"][1] == "int8"
        loaded = LLMPredictor.load(path, device="cpu")
        assert {n for n, m in loaded._model.named_modules()
                if isinstance(m, QuantizedLinearInfer)} == names
        for n, b in qt.named_buffers():
            assert torch.equal(dict(loaded._model.named_buffers())[n], b), n
        np.testing.assert_array_equal(
            loaded.generate(ids, max_new_tokens=8), want)


def test_set_flags_accepts_the_kernel_flag(kernel_flag):
    kernel_flag(True)
    assert get_flags(FLAG) == {FLAG: True}
    kernel_flag(False)
    assert get_flags([FLAG]) == {FLAG: False}


def _bf16_tol(lg):
    """``BF16_ULPS`` bf16 ulps of each position's top logit (at least
    ``MARGIN``)."""
    top = np.abs(lg).max(axis=-1)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(top, 1e-30))) - 7)
    return np.maximum(MARGIN, BF16_ULPS * ulp)


def test_example_step4_matches_jax():
    """Step 4 of ``examples/llama_serve.py`` (``weight_only_quantize`` with
    ``lm_head`` skipped, a 2x8 bf16 session of 12 tokens) against the
    twin's ``int8_session`` on the same weights (the JAX example's seed
    0), up to each row's first position within ``BF16_ULPS`` bf16 ulps of
    its top logit."""
    from paddle_tpu_torch.examples.llama_serve import int8_session
    paddle.seed(0)
    jnet = jmodels.LlamaForCausalLM(jmodels.tiny_llama_config())
    jnet.eval()
    arrays = {n: np.asarray(p._value) for n, p in jnet.named_parameters()}
    tnet = LlamaForCausalLM(tiny_llama_config(), device="cpu", init=False)
    tnet.load_state_dict(llama_state_from_jax(arrays))
    prompt = np.random.default_rng(0).integers(0, 256, (2, 8))
    qj = j_woq(jnet, inplace=False, skip=_skip_head)
    want = JaxPredictor(qj, batch=2, prompt_len=8, max_cache_len=32,
                        steps_per_call=4).generate(prompt, max_new_tokens=12)
    got = int8_session(tnet, prompt)
    assert isinstance(tnet.llama.layers[0].mlp.up_proj, torch.nn.Linear)
    compared = 0
    for p, g, w in zip(prompt, got, want):
        lg = _jax_forced(qj, p, np.asarray(w, np.int32))
        upto = _upto(lg, _bf16_tol(lg))
        np.testing.assert_array_equal(g[:upto], w[:upto])
        compared += upto
    assert compared >= 12, compared
