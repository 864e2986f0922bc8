"""The port's sampler (``paddle_tpu_torch/inference/sampling.py``, the
sampled half of ``models/generation.py`` and ``accept_drafts_sampled``)
held against the JAX package's functions on the CPU, on the same numpy
inputs (each package gets its own copy):

- the ``SamplingParams`` and ``DfaTokenMask`` contracts of
  ``tests/test_sampling.py`` (:67, :103), and ``flags_of``/``row_planes``
  equal to the JAX ones;
- ``process_logits`` with a repetition penalty and a mask bias: equal
  float32 bits;
- ``filter_top_k_top_p``: equal kept sets wherever no exclusive
  cumulative mass lies within 1e-6 of ``top_p``, ties at the threshold
  kept;
- ``sample_rows`` in all 16 flag buckets, ``sampled_decode_scan_body``
  over 4 steps (a stub model whose logits are a table lookup, so both
  packages see the same logits) and ``spec_sampling_draws``: tokens
  equal at every decisive position (the top two perturbed scores of the
  JAX side more than 1e-5 apart: the Gumbel noise of the two packages
  differs by at most 2 ulp), ``u`` bit-equal, ``accept_p`` within 1e-6;
  ``accept_drafts_sampled`` equal on the same draws;
- ``generate(do_sample=True)`` with top-k alone, top-p, and both, against
  the JAX ``generate()`` on bridged weights, token-equal up to each row's
  first position whose teacher-forced perturbed scores (the JAX model's
  logits / T, filtered, plus the noise of the same key) have a top-two
  margin <= 0.01;
- the first-token marginal of speculative sampling (``tests/
  test_sampling.py:373``) through the port's draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu.inference import sampling as J
from paddle_tpu.inference.speculative import \
    accept_drafts_sampled as j_accept_sampled
from paddle_tpu.models.generation import GenerationConfig as JCfg
from paddle_tpu.models.generation import \
    filter_top_k_top_p as j_filter
from paddle_tpu_torch.inference import sampling as T
from paddle_tpu_torch.inference import threefry
from paddle_tpu_torch.inference.speculative import accept_drafts_sampled
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_state_from_jax,
                                     tiny_llama_config)
from paddle_tpu_torch.models.generation import (GenerationConfig,
                                                filter_top_k_top_p)

B, V = 6, 256
NOISE_MARGIN = 1e-5
MARGIN = 0.01
BUCKETS = [tuple(bool(b >> i & 1) for i in range(4)) for b in range(16)]


def _t(a):
    """A torch copy of a numpy array (never the JAX side's buffer)."""
    return torch.from_numpy(np.array(a, copy=True))


def _planes(rng, b=B, v=V):
    """One dispatch's planes as numpy: a mix of greedy and sampled rows
    with top-k, top-p, penalties and mask biases."""
    greedy = np.array([i % 3 == 0 for i in range(b)])
    bias = np.zeros((b, v), np.float32)
    for i in range(b):
        banned = rng.random(v) < 0.5
        banned[rng.integers(0, v)] = False
        bias[i, banned] = J.MASK_BIAS
    return dict(
        base=np.stack([np.asarray(jax.random.PRNGKey(s), np.uint32)
                       for s in rng.integers(0, 2 ** 31, b)]),
        pos=rng.integers(0, 50, b).astype(np.int32),
        temp=np.where(greedy, 1.0, rng.uniform(0.5, 1.5, b)).astype(
            np.float32),
        top_k=np.where(greedy, 0, rng.choice([0, 5, 40], b)).astype(np.int32),
        top_p=np.where(greedy, 1.0, rng.choice([1.0, 0.9, 0.7], b)).astype(
            np.float32),
        greedy=greedy,
        rep=rng.choice([1.0, 1.3, 0.8], b).astype(np.float32),
        presence=rng.random((b, v)) < 0.2,
        bias=bias)


def _jax_planes(p):
    return {k: jnp.asarray(np.array(v, copy=True)) for k, v in p.items()}


def _torch_planes(p):
    out = {k: _t(v) for k, v in p.items()}
    out["base"] = out["base"].to(torch.int64)
    out["pos"] = out["pos"].to(torch.int64)
    out["top_k"] = out["top_k"].to(torch.int64)
    return out


def _perturbed(lg, planes, flags):
    """The JAX side's per-row scores that decide a draw: processed
    logits / T, filtered, plus the Gumbel noise of lane 1 at ``pos``;
    greedy rows: the processed logits."""
    sampled, filtered = flags[0], flags[1]
    samp = _jax_planes(planes)
    plg = J.process_logits(jnp.asarray(lg), samp, flags,
                           samp["presence"] if flags[2] else None)
    if not sampled:
        return np.asarray(plg), np.ones(lg.shape[0], bool)
    lgf = plg / samp["temp"][:, None]
    if filtered:
        lgf = j_filter(lgf, samp["top_k"], samp["top_p"])
    keys = J._fold_keys(samp["base"], samp["pos"], 1)
    g = jax.vmap(lambda k: jax.random.gumbel(k, (lg.shape[-1],)))(keys)
    return np.asarray(lgf + g), ~planes["greedy"]


def _margin(scores):
    top2 = np.sort(scores, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


# ---------------------------------------------------------------------------
# host-side contracts
# ---------------------------------------------------------------------------

def test_sampling_params_contract():
    SP = T.SamplingParams
    assert SP().is_greedy is False
    assert SP(temperature=0.0).is_greedy
    assert SP(temperature=1e-6).is_greedy
    assert SP(top_k=1).is_greedy
    assert SP(repetition_penalty=1.2).needs_penalty
    for bad in (dict(temperature=-0.1), dict(top_k=-1), dict(top_p=0.0),
                dict(top_p=1.5), dict(repetition_penalty=0.0),
                dict(mask_processor="nope")):
        with pytest.raises(ValueError):
            SP(**bad).validate()
        with pytest.raises(ValueError):
            J.SamplingParams(**bad).validate()
    assert T.TEMP_EPS == J.TEMP_EPS and T.MASK_BIAS == J.MASK_BIAS
    cases = [dict(temperature=0.0), dict(temperature=0.7),
             dict(temperature=0.7, top_k=5), dict(temperature=0.7,
                                                  top_p=0.9),
             dict(temperature=0.0, top_k=9),
             dict(temperature=0.0, repetition_penalty=2.0),
             dict(temperature=0.5, top_k=9, top_p=0.9),
             dict(temperature=1e-6), dict(top_k=1, temperature=3.0)]
    for c in cases:
        assert T.row_planes(T.SamplingParams(**c)) == \
            J.row_planes(J.SamplingParams(**c)), c
    assert T.row_planes(None) == J.row_planes(None)
    for i in range(len(cases)):
        for j in range(i, len(cases)):
            mix = [cases[i], None, cases[j]]
            assert T.flags_of([None if c is None else T.SamplingParams(**c)
                               for c in mix]) == \
                J.flags_of([None if c is None else J.SamplingParams(**c)
                            for c in mix])
    table = np.full((2, 8), -1, np.int32)
    table[0, 1] = 1
    assert T.flags_of([T.SamplingParams(
        temperature=0.0, mask_processor=T.DfaTokenMask(table))]) == \
        (False, False, False, True)
    np.testing.assert_array_equal(T.base_key(7), J.base_key(7))
    assert T.base_key(7).dtype == np.uint32


def test_dfa_token_mask_contract():
    with pytest.raises(ValueError, match="n_states"):
        T.DfaTokenMask(np.zeros((8,), np.int32))
    with pytest.raises(ValueError, match="start_state"):
        T.DfaTokenMask(np.zeros((2, 8), np.int32), start_state=5)
    table = np.full((2, 4), -1, np.int32)
    table[0, 1] = 1
    table[1, 2] = 0
    m = T.DfaTokenMask(table)
    m.begin(np.array([3, 3], np.int32))
    np.testing.assert_array_equal(m.allowed(), [False, True, False, False])
    m.advance(1)
    np.testing.assert_array_equal(m.allowed(), [False, False, True, False])
    with pytest.raises(RuntimeError, match="illegal"):
        m.advance(3)
    m.begin(np.zeros((1,), np.int32))
    assert m.state == 0
    assert isinstance(m, T.TokenMaskProcessor)


# ---------------------------------------------------------------------------
# the logit chain and the filter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [(False, False, True, False),
                                   (False, False, False, True),
                                   (True, True, True, True)])
def test_process_logits_bit_equal_jax(flags):
    rng = np.random.default_rng(1)
    lg = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    p = _planes(rng)
    js, ts = _jax_planes(p), _torch_planes(p)
    want = np.asarray(J.process_logits(jnp.asarray(lg), js, flags,
                                       js["presence"]))
    got = T.process_logits(_t(lg), ts, flags, ts["presence"]).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # bf16 logits: the float32 cast first, as in the reference
    lb = torch.from_numpy(lg.copy()).to(torch.bfloat16)
    want = np.asarray(J.process_logits(
        jnp.asarray(lb.float().numpy()).astype(jnp.bfloat16), js, flags,
        js["presence"]))
    got = T.process_logits(lb, ts, flags, ts["presence"]).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_filter_top_k_top_p_equal_kept_sets():
    rng = np.random.default_rng(2)
    rows, v = 200, 64
    lg = (rng.standard_normal((rows, v)) * 2).astype(np.float32)
    top_k = rng.choice([0, 1, 3, 10, 64], rows).astype(np.int32)
    top_p = rng.choice([1.0, 0.95, 0.8, 0.5, 0.1], rows).astype(np.float32)
    want = np.asarray(j_filter(jnp.asarray(lg), jnp.asarray(top_k),
                               jnp.asarray(top_p)))
    got = filter_top_k_top_p(_t(lg), _t(top_k).long(), _t(top_p)).numpy()
    # rows whose exclusive cumulative mass (after top-k) keeps clear of
    # top_p, in float64
    srt = -np.sort(-lg.astype(np.float64), axis=-1)
    keep_k = (top_k[:, None] <= 0) | (np.arange(v)[None] < top_k[:, None])
    e = np.exp(np.where(keep_k, srt - srt[:, :1], -np.inf))
    pr = e / e.sum(-1, keepdims=True)
    excl = np.cumsum(pr, -1) - pr
    clear = (np.abs(excl - top_p[:, None].astype(np.float64))
             > 1e-6).all(-1)
    print(f"filter: {int(clear.sum())} of {rows} rows compared")
    assert clear.sum() >= rows * 0.85, clear.sum()
    np.testing.assert_array_equal(np.isfinite(got[clear]),
                                  np.isfinite(want[clear]))
    kept = np.isfinite(got)
    np.testing.assert_array_equal(got[kept], lg[kept])
    # ties at the threshold are kept, in both packages
    tie = np.array([[4.0, 3.0, 3.0, 1.0, 0.0]], np.float32)
    for k, p in ((2, 1.0), (0, 0.5)):
        w = np.asarray(j_filter(jnp.asarray(tie), jnp.asarray([k]),
                                jnp.asarray([p], jnp.float32)))
        g = filter_top_k_top_p(_t(tie), torch.tensor([k]),
                               torch.tensor([p])).numpy()
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
    assert np.isfinite(filter_top_k_top_p(
        _t(tie), torch.tensor([2]), torch.tensor([1.0])).numpy()).sum() == 3


# ---------------------------------------------------------------------------
# the draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", BUCKETS,
                         ids=["".join("1" if f else "0" for f in fl)
                              for fl in BUCKETS])
def test_sample_rows_equal_jax_in_every_bucket(flags):
    rng = np.random.default_rng(3)
    lg = (rng.standard_normal((B, V)) * 2).astype(np.float32)
    p = _planes(rng)
    js, ts = _jax_planes(p), _torch_planes(p)
    want = np.asarray(J.sample_rows(jnp.asarray(lg), js, flags,
                                    js["presence"]))
    got = T.sample_rows(_t(lg), ts, flags, ts["presence"]).numpy()
    assert got.dtype == np.int32
    scores, _ = _perturbed(lg, p, flags)
    dec = _margin(scores) > NOISE_MARGIN
    if flags[0]:
        # greedy rows decide on the processed logits
        plg, _ = _perturbed(lg, p, (False,) + flags[1:])
        dec = np.where(p["greedy"], _margin(plg) > NOISE_MARGIN, dec)
    assert dec.sum() >= B - 1
    np.testing.assert_array_equal(got[dec], want[dec])


class _TableModel:
    """A stub whose decode step's logits are a row of a fixed table
    picked by (token + lens): both packages see the same float32 logits."""

    def __init__(self, table, lib):
        self.table, self.lib = table, lib

    def decode_step(self, tok, lens, kvs):
        r = self.table.shape[0]
        if self.lib == "jax":
            return self.table[(tok + lens) % r], kvs
        return self.table[((tok + lens) % r).long()], kvs


@pytest.mark.parametrize("flags", [(True, True, True, False),
                                   (True, False, False, True),
                                   (False, False, True, False)])
def test_sampled_decode_scan_body_equals_jax(flags):
    rng = np.random.default_rng(4)
    table = (rng.standard_normal((37, V)) * 2).astype(np.float32)
    p = _planes(rng)
    tok = rng.integers(0, V, B).astype(np.int32)
    lens = rng.integers(5, 20, B).astype(np.int32)
    done = np.array([False] * (B - 1) + [True])
    budget = np.array([9, 9, 2, 9, 9, 0], np.int32)
    cfg_j = JCfg(eos_token_id=int(tok[0]), pad_token_id=3)
    cfg_t = GenerationConfig(eos_token_id=int(tok[0]), pad_token_id=3)
    js, ts = _jax_planes(p), _torch_planes(p)
    body = J.sampled_decode_scan_body(
        _TableModel(jnp.asarray(table), "jax"), cfg_j, js, flags)
    carry = (jnp.asarray(tok), jnp.asarray(lens), None,
             js["pos"] if flags[0] else jnp.zeros(B, jnp.int32),
             js["presence"] if flags[2] else None, jnp.asarray(done),
             jnp.asarray(budget))
    (jtok, jlens, _, jpos, jpres, jdone, jbud), jtoks = jax.lax.scan(
        body, carry, None, length=4)
    tmodel = _TableModel(_t(table), "torch")
    tc = (_t(tok), _t(lens), None, ts["pos"] if flags[0] else None,
          ts["presence"] if flags[2] else None, _t(done), _t(budget))
    ttoks = []
    for _ in range(4):
        tc, nxt = T.decode_scan_step(tmodel, cfg_t, tc, ts, flags)
        ttoks.append(nxt)
    got = torch.stack(ttoks, 1).numpy()
    want = np.asarray(jtoks).T
    # the table's logits decide alone for every greedy step here; the
    # sampled steps' noise differs by at most 2 ulp
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tc[0].numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tc[1].numpy(), np.asarray(jlens))
    np.testing.assert_array_equal(tc[5].numpy(), np.asarray(jdone))
    np.testing.assert_array_equal(tc[6].numpy(), np.asarray(jbud))
    if flags[0]:
        np.testing.assert_array_equal(tc[3].numpy(), np.asarray(jpos))
    if flags[2]:
        np.testing.assert_array_equal(tc[4].numpy(), np.asarray(jpres))


def _spec_inputs(rng, c=4):
    lg = (rng.standard_normal((B, c, V)) * 2).astype(np.float32)
    toks = rng.integers(0, V, (B, c)).astype(np.int32)
    # some drafts are each position's argmax, so acceptance is likely
    toks[:, 1:] = np.where(rng.random((B, c - 1)) < 0.5,
                           lg[:, :-1].argmax(-1), toks[:, 1:])
    return lg, toks


@pytest.mark.parametrize("flags", [(True, False, False, False),
                                   (True, True, True, False)])
def test_spec_sampling_draws_equal_jax(flags):
    rng = np.random.default_rng(5)
    lg, toks = _spec_inputs(rng)
    p = _planes(rng)
    js, ts = _jax_planes(p), _torch_planes(p)
    want = [np.asarray(x) for x in J.spec_sampling_draws(
        jnp.asarray(lg), jnp.asarray(toks), js, flags, js["presence"])]
    got = [x.numpy() for x in T.spec_sampling_draws(
        _t(lg), _t(toks), ts, flags, ts["presence"])]
    greedy, u, accept_p, resample, sample = got
    np.testing.assert_array_equal(u.view(np.uint32), want[1].view(np.uint32))
    np.testing.assert_allclose(accept_p, want[2], rtol=0, atol=1e-6)
    # decisive positions of the greedy plane and of the two draws
    pres = np.asarray(J._expand_spec_presence(
        jnp.asarray(toks), js["presence"])) if flags[2] else None
    plg = np.asarray(J.process_logits(jnp.asarray(lg), js, flags, pres))
    np.testing.assert_array_equal(greedy[_margin(plg) > NOISE_MARGIN],
                                  want[0][_margin(plg) > NOISE_MARGIN])
    lgf = plg / p["temp"][:, None, None]
    if flags[1]:
        lgf = np.asarray(j_filter(
            jnp.asarray(lgf), jnp.broadcast_to(js["top_k"][:, None],
                                               toks.shape),
            jnp.broadcast_to(js["top_p"][:, None], toks.shape)))
    pos = p["pos"][:, None] + np.arange(toks.shape[1])[None]
    keys = J._fold_keys(jnp.asarray(np.repeat(p["base"], toks.shape[1], 0)),
                        jnp.asarray(pos.reshape(-1)), 1)
    g = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (V,)))(
        keys)).reshape(lgf.shape)
    d = np.concatenate([toks[:, 1:], np.zeros((B, 1), np.int32)], 1)
    res = np.where(np.eye(V, dtype=bool)[d], -np.inf, lgf)
    for got_i, want_i, scores in ((sample, want[4], lgf + g),
                                  (resample, want[3], res + g)):
        dec = _margin(scores) > NOISE_MARGIN
        assert dec.mean() > 0.9
        np.testing.assert_array_equal(got_i[dec], want_i[dec])
    # the acceptance walk on the same draws (the JAX ones)
    for i in range(B):
        drafts = toks[i, 1:]
        assert accept_drafts_sampled(drafts, *(w[i] for w in want[1:]),
                                     eos_token_id=None) == \
            j_accept_sampled(drafts, *(w[i] for w in want[1:]),
                             eos_token_id=None)
        eos = int(drafts[0])
        assert accept_drafts_sampled(drafts, *(w[i] for w in want[1:]),
                                     eos_token_id=eos) == \
            j_accept_sampled(drafts, *(w[i] for w in want[1:]),
                             eos_token_id=eos)


def test_spec_greedy_rows_with_penalty_equal_jax():
    rng = np.random.default_rng(6)
    lg, toks = _spec_inputs(rng)
    p = _planes(rng)
    js, ts = _jax_planes(p), _torch_planes(p)
    flags = (False, False, True, False)
    want = np.asarray(J.spec_greedy_rows(jnp.asarray(lg), jnp.asarray(toks),
                                         js, flags, js["presence"]))
    got = T.spec_greedy_rows(_t(lg), _t(toks), ts, flags,
                             ts["presence"]).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        T._expand_spec_presence(_t(toks), ts["presence"]).numpy(),
        np.asarray(J._expand_spec_presence(jnp.asarray(toks),
                                           js["presence"])))


def test_spec_sampling_first_token_marginal_exact():
    """Speculative sampling preserves the target distribution: the first
    emitted token's marginal over N independent streams of the port's
    draws is the target p (mirrors ``tests/test_sampling.py:373``)."""
    n, cw, v = 4000, 3, 8
    rng = np.random.default_rng(0)
    pos_logits = rng.standard_normal((cw, v)).astype(np.float32) * 1.5
    d0 = int(np.argmax(pos_logits[0]))
    d1 = int(np.argmin(pos_logits[1]))
    logits = torch.from_numpy(np.broadcast_to(pos_logits, (n, cw, v)).copy())
    toks = torch.from_numpy(np.broadcast_to(
        np.array([0, d0, d1], np.int32), (n, cw)).copy())
    base = threefry.fold_in(threefry.as_key(threefry.prng_key(0)).expand(
        n, 2), torch.arange(n))
    samp = dict(base=base, pos=torch.zeros(n, dtype=torch.int64),
                temp=torch.full((n,), 0.8), top_k=torch.full((n,), 6),
                top_p=torch.full((n,), 0.97),
                greedy=torch.zeros(n, dtype=torch.bool))
    greedy, u, accept_p, resample, sample = (
        x.numpy() for x in T.spec_sampling_draws(
            logits, toks, samp, (True, True, False, False)))
    np.testing.assert_array_equal(
        greedy, np.broadcast_to(np.argmax(pos_logits, -1), (n, cw)))
    p_tgt = [np.asarray(jax.nn.softmax(j_filter(
        jnp.asarray(pos_logits[j:j + 1] / np.float32(0.8)),
        jnp.asarray([6]), jnp.asarray([0.97], jnp.float32))))[0]
        for j in range(cw)]
    first = np.zeros((n,), np.int32)
    second = np.full((n,), -1, np.int32)
    n_resample = 0
    for i in range(n):
        emitted, acc, res = accept_drafts_sampled(
            [d0, d1], u[i], accept_p[i], resample[i], sample[i])
        first[i] = emitted[0]
        if acc >= 1:
            second[i] = emitted[1]
        n_resample += res
    assert n_resample > n * 0.05 and (second >= 0).sum() > n * 0.2
    emp = np.bincount(first, minlength=v) / n
    assert 0.5 * np.abs(emp - p_tgt[0]).sum() < 0.06, (emp, p_tgt[0])
    sel = second[second >= 0]
    emp2 = np.bincount(sel, minlength=v) / sel.size
    assert 0.5 * np.abs(emp2 - p_tgt[1]).sum() < 0.08, (emp2, p_tgt[1])
    assert abs((second >= 0).mean() - p_tgt[0][d0]) < 0.04


# ---------------------------------------------------------------------------
# generate(do_sample=True) on bridged weights
# ---------------------------------------------------------------------------

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


GEN_CASES = {"top_k": dict(temperature=0.9, top_k=20),
             "top_p": dict(temperature=1.1, top_p=0.9),
             "both": dict(temperature=0.8, top_k=30, top_p=0.85)}


def _gen_margins(jnet, ids, lens, out, kw, seed):
    """Top-two margins of the JAX side's teacher-forced perturbed scores
    at every generated position: the JAX model's logits / T, filtered as
    ``sample_token`` filters, plus the Gumbel noise of that step's key
    (``PRNGKey(seed)`` split into the first token's key and the loop's,
    the loop's split once a step)."""
    b, m = out.shape
    seqs = np.zeros((b, ids.shape[1] + m), np.int32)
    for i in range(b):
        s = np.concatenate([ids[i, :lens[i]], out[i, :-1]])
        seqs[i, :len(s)] = s
    logits = np.asarray(jnet(paddle.to_tensor(seqs))._value)
    key0, keyr = jax.random.split(jax.random.PRNGKey(seed))
    keys = [key0]
    for _ in range(m - 1):
        kt, keyr = jax.random.split(keyr)
        keys.append(kt)
    t = np.float32(max(kw["temperature"], 1e-6))
    k, p = kw.get("top_k", 0), kw.get("top_p", 1.0)
    margins = np.zeros((b, m))
    for step in range(m):
        lg = np.stack([logits[i, lens[i] - 1 + step] for i in range(b)]
                      ).astype(np.float32) / t
        lg = jnp.asarray(lg)
        if k > 0 and p >= 1.0:
            kth = jax.lax.top_k(lg, k)[0][..., -1:]
            lg = jnp.where(lg < kth, -jnp.inf, lg)
        else:
            lg = j_filter(lg, jnp.full((b,), k, jnp.int32),
                          jnp.full((b,), p, jnp.float32))
        g = jax.random.gumbel(keys[step], (b, lg.shape[-1]))
        margins[:, step] = _margin(np.asarray(lg + g))
    return margins


@pytest.mark.parametrize("case", list(GEN_CASES))
def test_generate_do_sample_equals_jax_at_decisive_positions(bridged, case):
    jnet, tnet = bridged
    kw = GEN_CASES[case]
    rng = np.random.default_rng(8)
    vocab = tiny_llama_config().vocab_size
    ids = rng.integers(0, vocab, (3, 7)).astype(np.int32)
    lens = np.array([7, 4, 6], np.int32)
    seed = 5
    want = np.asarray(jnet.generate(
        paddle.to_tensor(ids.copy()), seq_lens=lens.copy(),
        max_new_tokens=8, do_sample=True, seed=seed,
        compute_dtype="float32", **kw)._value)
    got = tnet.generate(ids.copy(), seq_lens=lens.copy(), max_new_tokens=8,
                        do_sample=True, seed=seed, compute_dtype="float32",
                        **kw).numpy()
    margins = _gen_margins(jnet, ids, lens, want, kw, seed)
    compared = 0
    for i in range(len(ids)):
        undecided = np.flatnonzero(margins[i] <= MARGIN)
        upto = int(undecided[0]) if undecided.size else margins.shape[1]
        np.testing.assert_array_equal(got[i, :upto], want[i, :upto])
        compared += upto
    print(f"generate(do_sample) {case}: {compared} of {margins.size} "
          f"positions compared")
    # a draw is decisive with probability about 0.99 on this vocabulary,
    # and a row is compared only up to its first undecided draw
    assert compared >= 0.5 * margins.size
    # greedy generate() is unchanged by the sampled path
    g = tnet.generate(ids.copy(), seq_lens=lens.copy(), max_new_tokens=4,
                      compute_dtype="float32", **kw).numpy()
    gj = np.asarray(jnet.generate(paddle.to_tensor(ids.copy()),
                                  seq_lens=lens.copy(), max_new_tokens=4,
                                  compute_dtype="float32", **kw)._value)
    np.testing.assert_array_equal(g, gj)
