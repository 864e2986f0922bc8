"""The port's flight recorder and goodput ledger held against the JAX
engine's, event for event, on the JAX package's combined trace
(``tests/test_flightrec.py``): request A decodes, a priority-1 spec
request B (``spec_decode=2``, a stub drafter that repeats the last
token, so the verifier rejects most drafts) preempts A to the host tier,
A resumes and finishes, then C shares 5 prompt tokens with A and hits
the radix cache partially (2 blocks mapped, 1 token recomputed).

Both engines run the trace in lockstep on a step clock the test owns,
each with a private registry and an enabled ``FlightRecorder``, in three
arms: the lockstep engine (``async_dispatch=False``) and dispatch-ahead
at depth 1 and 3.  Before every step the JAX engine's arena bytes are
copied into the port's, so both verify and decode from the same KV
bytes.  Per arm the two engines agree on the flight records (every
field but ``wall``), ``explain()`` of every request, every counter both
registries hold (and the gauges and the deterministic histogram), and
``stats()`` on every shared key that is not a wall time, with
``useful + wasted == dispatched`` exactly.  The JAX package's
``load_flight_record``, ``explain_events`` and ``tools/explain_request.py``
read the port's export and give the same sentences."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.observability import flightrec as jflightrec
from paddle_tpu.observability.metrics import MetricsRegistry
from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.inference.serving import GOODPUT_REASONS
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_state_from_jax,
                                     tiny_llama_config)
from paddle_tpu_torch.observability import FlightRecorder
from paddle_tpu_torch.observability import MetricsRegistry as TorchRegistry
from paddle_tpu_torch.observability.flightrec import load_flight_record

P, C, BL = 8, 24, 2
ARMS = (0, 1, 3)          # 0 = async_dispatch=False, else async_depth


class StepClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


class AlwaysDraft:
    """Proposes k repeats of the last token: random weights reject most
    of them, which is what the spec_reject lane of the ledger needs."""

    def propose(self, context, k):
        return np.repeat(np.asarray(context[-1:], np.int32), k)


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


def _copy_arenas(jeng, teng):
    for ja, ta in zip(jeng._arenas, teng._arenas):
        ta.copy_(torch.from_numpy(np.array(np.asarray(ja), copy=True)))


def _engine(cls, net, arm):
    clock = StepClock()
    mode = dict(async_dispatch=False) if arm == 0 else dict(
        async_dispatch=True, async_depth=arm)
    extra = dict(registry=MetricsRegistry(),
                 flight_recorder=jflightrec.FlightRecorder()) \
        if cls is JaxEngine else dict(registry=TorchRegistry(),
                                      flight_recorder=FlightRecorder(),
                                      device="cpu")
    eng = cls(net, num_slots=2, prompt_len=P, max_cache_len=C,
              steps_per_call=1, block_len=BL, num_blocks=10,
              compute_dtype="float32", drafter=AlwaysDraft(), clock=clock,
              **mode, **extra)
    return eng, clock


def _lockstep(pair, until, limit):
    """Step both engines until ``until(reqs)`` holds on each, copying the
    JAX arenas into the port's before every step."""
    steps = 0
    while not all(until(reqs) for _e, _c, reqs in pair):
        _copy_arenas(pair[0][0], pair[1][0])
        for eng, clock, _reqs in pair:
            eng.step(clock.now)
            clock.now += 1.0
            eng._pool.check()
        steps += 1
        assert steps < limit, "trace did not drain"


def _run_arm(jnet, tnet, arm):
    vocab = tiny_llama_config().vocab_size
    rng = np.random.default_rng(5)
    ids_a = rng.integers(0, vocab, (6,)).astype(np.int32)
    ids_b = rng.integers(0, vocab, (6,)).astype(np.int32)
    ids_c = ids_a.copy()
    ids_c[5] = (ids_c[5] + 1) % vocab           # shares exactly 5 tokens
    pair = [(*_engine(JaxEngine, jnet, arm), []),
            (*_engine(ServingEngine, tnet, arm), [])]
    for eng, _clock, reqs in pair:
        reqs.append(eng.submit(ids_a.copy(), max_new_tokens=8))
    _lockstep(pair, lambda reqs: reqs[0].state == "decode", 10)
    for eng, _clock, reqs in pair:
        reqs.append(eng.submit(ids_b.copy(), max_new_tokens=4, priority=1,
                               spec_decode=2))
    _lockstep(pair, lambda reqs: all(r.state == "finished" for r in reqs),
              60)
    for eng, _clock, reqs in pair:
        reqs.append(eng.submit(ids_c.copy(), max_new_tokens=3))
    _lockstep(pair, lambda reqs: reqs[2].state == "finished", 40)
    for eng, _clock, _reqs in pair:
        eng.run()
        eng._pool.check()
    (jeng, _, jreqs), (teng, _, treqs) = pair
    return dict(jeng=jeng, teng=teng, jreqs=jreqs, treqs=treqs,
                jst=jeng.stats(), tst=teng.stats())


@pytest.fixture(scope="module")
def arms(bridged):
    jnet, tnet = bridged
    return {arm: _run_arm(jnet, tnet, arm) for arm in ARMS}


def _strip(events):
    return [(e.seq, e.step, e.request, e.kind,
             tuple(sorted((k, str(v)) for k, v in e.attrs.items())))
            for e in events]


@pytest.mark.parametrize("arm", ARMS)
def test_flight_records_equal_jax(arms, arm):
    r = arms[arm]
    jev = r["jeng"].flight_recorder.events()
    tev = r["teng"].flight_recorder.events()
    assert _strip(tev) == _strip(jev)
    kinds = {e.kind for e in tev}
    for k in ("submit", "admit", "prefill_chunk", "decode_block",
              "spec_verify", "preempt", "swap_out", "swap_in",
              "prefix_hit", "finish"):
        assert k in kinds, k
    if arm == 3:
        assert any("lag" in e.attrs for e in tev if e.kind == "decode_block")


@pytest.mark.parametrize("arm", ARMS)
def test_explain_equal_jax(arms, arm):
    r = arms[arm]
    for jq, tq in zip(r["jreqs"], r["treqs"]):
        assert tq.request_id == jq.request_id
        assert r["teng"].explain(tq.request_id) == \
            r["jeng"].explain(jq.request_id)
    a = r["treqs"][0]
    text = r["teng"].explain(a.request_id)
    assert "preempted at step" in text and "(7 blocks to host" in text
    assert "resumed at step" in text and "via 7 host blocks" in text
    assert "prefix hit" in r["teng"].explain(r["treqs"][2].request_id)


def _cells(reg, name):
    return reg.get(name)._snap()


@pytest.mark.parametrize("arm", ARMS)
def test_registry_instruments_equal_jax(arms, arm):
    """Every counter and gauge both registries hold has equal cells
    (values and high-water marks); the accepted-length histogram (a
    token count, not a time) is equal bucket for bucket, and every
    histogram of times has the same observation count."""
    r = arms[arm]
    treg, jreg = r["teng"].metrics_registry, r["jeng"].metrics_registry
    shared = sorted(set(treg.names()) & set(jreg.names()))
    assert len(shared) == len(treg.names())
    n_counters = 0
    for name in shared:
        t, j = _cells(treg, name), _cells(jreg, name)
        if t["type"] in ("counter", "gauge"):
            assert t == j, name
            n_counters += t["type"] == "counter"
        elif name == "serving.spec.accepted_length":
            assert t == j, name
        else:
            assert {k: c["count"] for k, c in t["values"].items()} == \
                {k: c["count"] for k, c in j["values"].items()}, name
    assert n_counters >= 40


WALL_KEYS = ("mean_latency_s", "mean_ttft_s", "mean_tpot_s")


@pytest.mark.parametrize("arm", ARMS)
def test_stats_equal_jax_and_ledger_conserves(arms, arm):
    r = arms[arm]
    ts, js = r["tst"], r["jst"]
    shared = [k for k in ts if k in js and k not in WALL_KEYS]
    assert len(shared) >= 60
    for k in shared:
        assert ts[k] == js[k], (k, ts[k], js[k])
    for k in WALL_KEYS:
        assert (ts[k] is None) == (js[k] is None), k
    # the ledger: conservation, and the JAX test's reconciliation of the
    # dispatched total against an independent model of every dispatch
    assert ts["useful_tokens"] + ts["wasted_tokens"] \
        == ts["dispatched_tokens"] > 0
    assert ts["wasted_tokens"] == sum(ts["wasted_by_reason"].values())
    assert set(ts["wasted_by_reason"]) == set(GOODPUT_REASONS)
    rec = r["teng"].flight_recorder
    verify_rows = [e for e in rec.events() if e.kind == "spec_verify"]
    width = r["teng"]._spec_k_max + 1
    assert ts["dispatched_tokens"] == (ts["prefill_chunks"] * P
                                       + ts["busy_slot_steps"]
                                       + len(verify_rows) * width)
    assert ts["wasted_by_reason"]["spec_reject"] == \
        sum(int(e.attrs["rejected"]) for e in verify_rows) > 0
    assert ts["wasted_by_reason"]["recompute_cache"] == 1
    assert ts["prefix_hit_tokens"] == 4 and ts["prefix_partial_hits"] == 1
    assert ts["wasted_by_reason"]["recompute_preempt"] == 0
    assert ts["preemptions"] == 1 and ts["preempt_resumes"] == 1
    assert ts["handoffs"] == 0 and ts["role"] == "both"


@pytest.mark.parametrize("arm", ARMS)
def test_tokens_equal_jax(arms, arm):
    """With the arenas copied every step both engines score the same KV
    bytes, so the streams are equal token for token."""
    r = arms[arm]
    for jq, tq in zip(r["jreqs"], r["treqs"]):
        assert tq.state == jq.state == "finished"
        np.testing.assert_array_equal(tq.output, jq.output)


def _load_cli():
    path = os.path.join(os.path.dirname(__file__), "..", "tools",
                        "explain_request.py")
    spec = importlib.util.spec_from_file_location("explain_request", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arm", ARMS)
def test_reference_readers_read_port_export(arms, arm, tmp_path, capsys):
    """The port's export is the JAX package's format: its
    ``load_flight_record`` and ``explain_events`` give the port's own
    sentences, the port's loader reads the JAX export back, and the CLI
    explains every request of the port's record."""
    r = arms[arm]
    tpath, jpath = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    header = r["teng"].flight_recorder.export(tpath)
    assert header == r["jeng"].flight_recorder.export(jpath)
    loaded = jflightrec.load_flight_record(tpath)
    assert _strip(loaded) == _strip(r["teng"].flight_recorder.events())
    back = load_flight_record(jpath)
    assert _strip(back) == _strip(loaded)
    for q in r["treqs"]:
        want = r["teng"].explain(q.request_id)
        assert jflightrec.explain_events(loaded, q.request_id) == want
        assert jflightrec.explain_events(back, q.request_id) == want
    cli = _load_cli()
    assert cli.main([tpath]) == 0
    out = capsys.readouterr().out
    for q in r["treqs"]:
        assert r["teng"].explain(q.request_id) in out
