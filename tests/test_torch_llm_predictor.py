"""The port's ``LLMPredictor`` held against the JAX package's on the CPU,
on the JAX model's weights carried by the weight bridge (float32, a tiny
Llama), mirroring ``tests/test_llm_predictor.py``'s Llama cases:

- the session equals ``generate()`` (the port's) and the JAX session,
  token for token; the incremental session equals one ``generate()``;
- greedy, sampled (the stream of a seed; another seed changes it) and
  beam round trips through the port's artifact (``.ptpu_torch_llm``),
  deterministic across calls;
- beam with mid-block truncation (``steps_per_call=4``,
  ``max_new_tokens=6``) equals the JAX session and ``generate()``;
- ``weight_dtype`` int8 and int4 against the JAX session of the same
  plan;
- every guard of the reference, with its message.
"""

import os
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu.inference import LLMPredictor as JaxPredictor
from paddle_tpu_torch.inference.llm import ARTIFACT_SUFFIX, LLMPredictor
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_state_from_jax,
                                     tiny_llama_config)


@pytest.fixture(scope="module")
def bridged():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    paddle.seed(2024)
    jnet = jmodels.LlamaForCausalLM(jmodels.tiny_llama_config())
    jnet.eval()
    arrays = {n: np.asarray(p._value) for n, p in jnet.named_parameters()}
    tnet = LlamaForCausalLM(tiny_llama_config(), device="cpu", init=False)
    tnet.load_state_dict(llama_state_from_jax(arrays))
    yield jnet, tnet
    torch.set_num_threads(prev)


def _ids(seed, b, p):
    rng = np.random.default_rng(seed)
    return rng.integers(0, tiny_llama_config().vocab_size,
                        (b, p)).astype(np.int32)


def _pair(bridged, **kw):
    """The same predictor in both packages: (port, JAX)."""
    jnet, tnet = bridged
    kw.setdefault("compute_dtype", "float32")
    return LLMPredictor(tnet, **kw), JaxPredictor(jnet, **kw)


def test_session_matches_generate_and_jax(bridged):
    _jnet, tnet = bridged
    ids = _ids(0, 2, 6)
    tp, jp = _pair(bridged, batch=2, prompt_len=6, max_cache_len=32,
                   steps_per_call=4)
    got = tp.generate(ids, max_new_tokens=9)
    want = tnet.generate(ids, max_new_tokens=9, max_cache_len=32,
                         compute_dtype="float32").numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jp.generate(ids.copy(),
                                                   max_new_tokens=9))


def test_session_is_incremental(bridged):
    ids = _ids(1, 1, 5)
    tp, jp = _pair(bridged, batch=1, prompt_len=5, max_cache_len=24,
                   steps_per_call=3)
    first = tp.start(ids)
    a = tp.decode(2)
    b = tp.decode(3)
    got = np.concatenate([first[:, None], a, b], axis=1)
    whole, _ = _pair(bridged, batch=1, prompt_len=5, max_cache_len=24,
                     steps_per_call=3)
    np.testing.assert_array_equal(got, whole.generate(ids, max_new_tokens=6))
    jfirst = jp.start(ids.copy())
    want = np.concatenate([jfirst[:, None], jp.decode(2), jp.decode(3)],
                          axis=1)
    np.testing.assert_array_equal(got, want)


def test_ragged_session_matches_jax(bridged):
    ids = _ids(9, 3, 7)
    lens = np.array([7, 3, 5], np.int32)
    tp, jp = _pair(bridged, batch=3, prompt_len=7, max_cache_len=20,
                   steps_per_call=5, eos_token_id=None)
    np.testing.assert_array_equal(
        tp.generate(ids, seq_lens=lens, max_new_tokens=11),
        jp.generate(ids.copy(), seq_lens=lens.copy(), max_new_tokens=11))


def _roundtrip(pred, tmp_path, name, **kw):
    want = pred.generate(kw.pop("ids"), **kw)
    path = str(tmp_path / name)
    pred.save(path)
    assert os.path.isfile(path + ARTIFACT_SUFFIX)
    loaded = LLMPredictor.load(path, device="cpu")
    return want, loaded


def test_artifact_roundtrip_deterministic(bridged, tmp_path):
    ids = _ids(2, 2, 4)
    tp, jp = _pair(bridged, batch=2, prompt_len=4, max_cache_len=16,
                   steps_per_call=4)
    want, loaded = _roundtrip(tp, tmp_path, "llama_serve", ids=ids,
                              max_new_tokens=8)
    np.testing.assert_array_equal(want, jp.generate(ids.copy(),
                                                    max_new_tokens=8))
    np.testing.assert_array_equal(loaded.generate(ids, max_new_tokens=8),
                                  want)
    np.testing.assert_array_equal(loaded.generate(ids, max_new_tokens=8),
                                  want)


def test_artifact_layout(bridged, tmp_path):
    """The artifact holds the version, the reference's meta dict key for
    key, the family with its config, and every weight at its bits."""
    tp, jp = _pair(bridged, batch=1, prompt_len=4, max_cache_len=8,
                   steps_per_call=2)
    path = str(tmp_path / "layout")
    tp.save(path)
    with open(path + ARTIFACT_SUFFIX, "rb") as f:
        blob = pickle.load(f)
    assert blob["version"] == 1 and blob["family"] == "llama"
    assert set(blob["meta"]) == {
        "batch", "prompt_len", "max_cache_len", "steps_per_call",
        "eos_token_id", "pad_token_id", "do_sample", "temperature", "top_k",
        "top_p", "num_beams", "length_penalty", "compute_dtype",
        "cache_dtype"}
    assert blob["config"]["vocab_size"] == tiny_llama_config().vocab_size
    _jnet, tnet = bridged
    for name, t in tnet.state_dict().items():
        bits, dt = blob["weights"][name]
        assert dt == "float32"
        np.testing.assert_array_equal(bits, t.numpy())
    bf = LlamaForCausalLM(tiny_llama_config(), device="cpu", seed=3,
                          dtype="bfloat16")
    bpath = str(tmp_path / "bf16")
    LLMPredictor(bf, batch=1, prompt_len=4, max_cache_len=8).save(bpath)
    loaded = LLMPredictor.load(bpath, device="cpu")
    for (name, a), b in zip(bf.state_dict().items(),
                            loaded._model.state_dict().values()):
        assert b.dtype == torch.bfloat16
        assert torch.equal(a.view(torch.int16), b.view(torch.int16)), name


def test_sampled_artifact_roundtrip(bridged, tmp_path):
    ids = _ids(3, 2, 4)
    kw = dict(batch=2, prompt_len=4, max_cache_len=16, steps_per_call=4,
              do_sample=True, temperature=0.8, top_k=5)
    tp, jp = _pair(bridged, **kw)
    want, loaded = _roundtrip(tp, tmp_path, "llama_sampled", ids=ids,
                              max_new_tokens=8, seed=11)
    np.testing.assert_array_equal(
        want, jp.generate(ids.copy(), max_new_tokens=8, seed=11))
    got = loaded.generate(ids, max_new_tokens=8, seed=11)
    np.testing.assert_array_equal(got, want)
    other = loaded.generate(ids, max_new_tokens=8, seed=12)
    assert not np.array_equal(got, other)
    assert (got >= 0).all() and (got < tiny_llama_config().vocab_size).all()


def test_beam_predictor_matches_generate_jax_and_artifact(bridged,
                                                          tmp_path):
    """steps_per_call=4 with max_new_tokens=6: the second block overshoots,
    and the host truncates the tree and scores at step 6 exactly."""
    _jnet, tnet = bridged
    ids = _ids(4, 2, 5)
    want = tnet.generate(ids, max_new_tokens=6, num_beams=3,
                         max_cache_len=16, compute_dtype="float32").numpy()
    tp, jp = _pair(bridged, batch=2, prompt_len=5, max_cache_len=16,
                   steps_per_call=4, num_beams=3)
    got, loaded = _roundtrip(tp, tmp_path, "llama_beam", ids=ids,
                             max_new_tokens=6)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(jp.generate(ids.copy(), max_new_tokens=6),
                                  want)
    np.testing.assert_array_equal(loaded.generate(ids, max_new_tokens=6),
                                  want)
    assert tp.start(ids).shape == (2, 3)


def test_beam_with_eos_and_penalty_matches_jax(bridged):
    _jnet, tnet = bridged
    ids = _ids(5, 2, 5)
    free = tnet.generate(ids, max_new_tokens=7, num_beams=2,
                         max_cache_len=20, compute_dtype="float32").numpy()
    kw = dict(batch=2, prompt_len=5, max_cache_len=20, steps_per_call=3,
              num_beams=2, eos_token_id=int(free[1, 1]), pad_token_id=255,
              length_penalty=1.0)
    tp, jp = _pair(bridged, **kw)
    got = tp.generate(ids, max_new_tokens=7)
    np.testing.assert_array_equal(got, jp.generate(ids.copy(),
                                                   max_new_tokens=7))


@pytest.mark.parametrize("wd", ["int8", "int4"])
def test_weight_dtype_session_matches_jax(bridged, wd):
    ids = _ids(23, 2, 6)
    tp, jp = _pair(bridged, batch=2, prompt_len=6, max_cache_len=32,
                   steps_per_call=4, weight_dtype=wd)
    assert tp.weight_dtype == wd
    first = tp.start(ids)
    got = np.concatenate([first[:, None], tp.decode(8)], axis=1)
    jfirst = jp.start(paddle.to_tensor(ids.copy()))
    want = np.concatenate([jfirst[:, None], jp.decode(8)], axis=1)
    np.testing.assert_array_equal(got, want)
    assert tp._wq.bits == {"int8": 8, "int4": 4}[wd]


def test_session_guards(bridged, tmp_path):
    _jnet, tnet = bridged
    pred = LLMPredictor(tnet, batch=1, prompt_len=4, max_cache_len=8,
                        steps_per_call=2, compute_dtype="float32")
    with pytest.raises(RuntimeError, match="start"):
        pred.decode(1)
    with pytest.raises(ValueError, match="prompt must be"):
        pred.start(np.zeros((2, 4), np.int64))
    pred.start(np.zeros((1, 4), np.int64))
    with pytest.raises(ValueError, match="max_cache_len"):
        pred.decode(100)
    assert pred.decode(0).shape == (1, 0)
    with pytest.raises(ValueError, match="max_new_tokens"):
        pred.generate(np.zeros((1, 4), np.int64), max_new_tokens=0)
    with pytest.raises(ValueError, match="prompt_len"):
        LLMPredictor(tnet, batch=1, prompt_len=8, max_cache_len=4)
    with pytest.raises(ValueError, match="seq_lens"):
        pred.start(np.zeros((1, 4), np.int64), seq_lens=np.array([9]))
    with pytest.raises(ValueError, match="seq_lens"):
        pred.start(np.zeros((1, 4), np.int64), seq_lens=np.array([0]))
    with pytest.raises(ValueError, match="needs a model"):
        LLMPredictor(batch=1, prompt_len=4)


def test_beam_guards(bridged):
    _jnet, tnet = bridged
    pred = LLMPredictor(tnet, batch=1, prompt_len=4, max_cache_len=16,
                        num_beams=2, compute_dtype="float32")
    with pytest.raises(RuntimeError, match="generate"):
        pred.decode(3)
    with pytest.raises(ValueError, match="do_sample"):
        LLMPredictor(tnet, batch=1, prompt_len=4, max_cache_len=16,
                     num_beams=2, do_sample=True)
    with pytest.raises(ValueError, match="max_cache_len"):
        LLMPredictor(tnet, batch=1, prompt_len=4, max_cache_len=6,
                     steps_per_call=4, num_beams=2,
                     compute_dtype="float32").generate(
                         np.zeros((1, 4), np.int64), max_new_tokens=4)


def test_artifact_and_dtype_guards(bridged, tmp_path):
    _jnet, tnet = bridged
    q = LLMPredictor(tnet, batch=1, prompt_len=4, max_cache_len=8,
                     compute_dtype="float32", weight_dtype="int8")
    with pytest.raises(NotImplementedError, match="weight_dtype"):
        q.save(str(tmp_path / "q"))
    with pytest.raises(ValueError, match="weight_dtype"):
        LLMPredictor(tnet, batch=1, prompt_len=4, weight_dtype="int8",
                     _loaded=True)
    with pytest.raises(ValueError, match="weight_dtype"):
        LLMPredictor(tnet, batch=1, prompt_len=4, weight_dtype="int16")
    with pytest.raises(NotImplementedError, match="cache_dtype"):
        LLMPredictor(tnet, batch=1, prompt_len=4, compute_dtype="float32",
                     cache_dtype="bfloat16")
    path = str(tmp_path / "old")
    with open(path + ARTIFACT_SUFFIX, "wb") as f:
        pickle.dump({"version": 2, "family": "llama"}, f)
    with pytest.raises(ValueError, match="version"):
        LLMPredictor.load(path, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            LLMPredictor.load(path)
