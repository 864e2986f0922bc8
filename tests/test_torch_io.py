"""The port's data pipeline, metrics and checkpoint files held against the
JAX package's on the CPU: the samplers, ``random_split`` (index-equal:
the same generator draw and ``jax.random.permutation``'s rule),
``default_collate_fn``, the ``DataLoader`` in sync, thread and process
mode (batch order, ``get_worker_info``, a worker's error, the
process-to-thread fallback with CUDA live), ``Accuracy``/``Precision``/
``Recall``/``Auc`` (tied scores included), ``save``/``load`` both ways
through the reference's envelope (bf16 included), and the rank and
world size of ``distributed``.  The reference's wall-clock overlap
assertion is not copied (it is unsteady under load); order and worker
identity are checked instead.
"""

import os
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu.io as jio
import paddle_tpu.metric as jmetric
import paddle_tpu_torch as paddle
import paddle_tpu_torch.io as tio
import paddle_tpu_torch.metric as tmetric


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class _Items(tio.Dataset):
    """``(float32 [3] row, int64 label)`` items; the pid of the process
    that fetched each one rides in the row."""

    def __len__(self):
        return 10

    def __getitem__(self, i):
        return (np.asarray([i, os.getpid(), 0], np.float32),
                np.int64(i % 3))


class _Boom(tio.Dataset):
    def __len__(self):
        return 6

    def __getitem__(self, i):
        if i == 3:
            raise ValueError("bad sample 3")
        return np.asarray([i], np.int64)


class _Info(tio.Dataset):
    def __len__(self):
        return 8

    def __getitem__(self, i):
        info = tio.get_worker_info()
        return np.asarray([i, info.id, info.num_workers], np.int64)


def test_samplers_match_jax():
    for drop_last in (False, True):
        for bs in (1, 3, 4):
            want = list(jio.BatchSampler(range(10), batch_size=bs,
                                         drop_last=drop_last))
            got = list(tio.BatchSampler(range(10), batch_size=bs,
                                        drop_last=drop_last))
            assert got == want
            assert len(tio.BatchSampler(range(10), batch_size=bs,
                                        drop_last=drop_last)) == len(want)
    for shuffle in (False, True):
        for rank in (0, 1, 2):
            kw = dict(batch_size=2, num_replicas=3, rank=rank,
                      shuffle=shuffle)
            js = jio.DistributedBatchSampler(range(11), **kw)
            ts = tio.DistributedBatchSampler(range(11), **kw)
            js.set_epoch(4)
            ts.set_epoch(4)
            assert list(ts) == list(js) and len(ts) == len(js)
    perm = list(tio.RandomSampler(range(12)))
    assert sorted(perm) == list(range(12))
    assert len(list(tio.RandomSampler(range(12), replacement=True,
                                      num_samples=5))) == 5
    assert sorted(tio.SubsetRandomSampler([5, 6, 7])) == [0, 1, 2]
    assert list(tio.SequenceSampler(range(4))) == [0, 1, 2, 3]
    w = list(tio.WeightedRandomSampler([0.0, 1.0, 0.0], 6))
    assert w == [1] * 6


def test_distributed_sampler_reads_the_world(monkeypatch):
    from paddle_tpu_torch import distributed as dist
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    assert (dist.get_rank(), dist.get_world_size()) == (1, 2)
    ts = tio.DistributedBatchSampler(range(7), batch_size=2)
    assert (ts.local_rank, ts.nranks) == (1, 2)
    assert list(ts) == list(jio.DistributedBatchSampler(
        range(7), batch_size=2, num_replicas=2, rank=1))
    monkeypatch.delenv("PADDLE_TRAINER_ID")
    monkeypatch.delenv("PADDLE_TRAINERS_NUM")
    assert (dist.get_rank(), dist.get_world_size()) == (0, 1)


@pytest.mark.parametrize("seed,lengths", [(0, [3, 7]), (5, [0.25, 0.75]),
                                          (11, [40, 30, 30])])
def test_random_split_is_index_equal(seed, lengths):
    """The same seed and draw count give the reference's subsets, index
    for index (its key is the draw's threefry part)."""
    n = int(sum(lengths)) if isinstance(lengths[0], int) else 20
    jpaddle.seed(seed)
    paddle.seed(seed)
    jpaddle.core.generator.default_generator().next_key()  # one draw each
    paddle.core.generator.default_generator().draw()
    want = jio.random_split(list(range(n)), lengths)
    got = tio.random_split(list(range(n)), lengths)
    assert [s.indices for s in got] == [list(s.indices) for s in want]
    assert sorted(i for s in got for i in s.indices) == list(range(n))
    g = paddle.core.generator.Generator(seed + 1)
    jg = jpaddle.core.generator.Generator(seed + 1)
    assert [s.indices for s in tio.random_split(list(range(n)), lengths,
                                                 generator=g)] == \
        [list(s.indices) for s in jio.random_split(list(range(n)), lengths,
                                                    generator=jg)]


def test_datasets_match_jax():
    a = np.arange(12, dtype=np.float32).reshape(6, 2)
    b = np.arange(6)
    td = tio.TensorDataset([torch.tensor(a), torch.tensor(b)])
    assert len(td) == 6 and torch.equal(td[4][0], torch.tensor(a[4]))
    cd = tio.ConcatDataset([list(range(3)), list(range(10, 14))])
    jcd = jio.ConcatDataset([list(range(3)), list(range(10, 14))])
    assert [cd[i] for i in range(-7, 7)] == [jcd[i] for i in range(-7, 7)]
    comp = tio.ComposeDataset([td, tio.Subset(list(range(100)), [9, 8])])
    assert len(comp) == 2 and comp[1][2] == 8
    chain = tio.ChainDataset([[1, 2], [3]])
    assert [x for x in iter(chain)] == [1, 2, 3]


def test_default_collate_matches_jax():
    batch = [{"x": np.full((2,), i, np.float32), "y": i, "z": float(i),
              "s": f"s{i}", "t": (np.int32(i), [np.float64(i)])}
             for i in range(3)]
    want = jio.default_collate_fn(batch)
    got = tio.default_collate_fn(batch)
    assert sorted(got) == sorted(want)
    for k in ("x", "y", "z"):
        assert got[k].dtype == np.asarray(want[k]).dtype
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    assert got["s"] == want["s"]
    np.testing.assert_array_equal(got["t"][0], want["t"][0])
    np.testing.assert_array_equal(got["t"][1][0], want["t"][1][0])
    stacked = tio.default_collate_fn([torch.ones(2, dtype=torch.bfloat16),
                                      torch.zeros(2, dtype=torch.bfloat16)])
    assert stacked.dtype == torch.bfloat16 and stacked.shape == (2, 2)


@pytest.mark.parametrize("mode", ["sync", "threads", "processes"])
def test_dataloader_order_and_workers(mode):
    workers = 0 if mode == "sync" else 2
    dl = tio.DataLoader(_Items(), batch_size=4, num_workers=workers,
                        use_process_workers=mode == "processes",
                        places="cpu")
    batches = list(dl)
    assert len(batches) == len(dl) == 3
    rows = torch.cat([b[0] for b in batches]).numpy()
    np.testing.assert_array_equal(rows[:, 0], np.arange(10))
    labels = torch.cat([b[1] for b in batches])
    assert labels.dtype == torch.int64
    np.testing.assert_array_equal(labels.numpy(), np.arange(10) % 3)
    pids = set(rows[:, 1].astype(np.int64).tolist())
    if mode == "processes":
        assert os.getpid() not in pids and len(pids) == 2
    else:
        assert pids == {os.getpid()}
    want = [np.asarray(b[1]._value) for b in jio.DataLoader(
        _Items(), batch_size=4, use_process_workers=False)]
    assert [b[1].tolist() for b in batches] == [w.tolist() for w in want]


@pytest.mark.parametrize("mode", ["threads", "processes"])
def test_dataloader_worker_error_and_info(mode):
    proc = mode == "processes"
    dl = tio.DataLoader(_Boom(), batch_size=2, num_workers=2,
                        use_process_workers=proc, places="cpu")
    err = RuntimeError if proc else ValueError
    with pytest.raises(err, match="bad sample 3"):
        list(dl)
    out = torch.cat(list(tio.DataLoader(_Info(), batch_size=2, num_workers=2,
                                        use_process_workers=proc,
                                        places="cpu"))).numpy()
    np.testing.assert_array_equal(out[:, 0], np.arange(8))
    assert set(out[:, 2].tolist()) == {2}
    assert set(out[:, 1].tolist()) <= {0, 1}


def test_iterable_dataset_workers_shard():
    class _Shards(tio.IterableDataset):
        def __iter__(self):
            info = tio.get_worker_info()
            for i in range(info.id, 8, info.num_workers):
                yield np.asarray([i], np.int64)

    for proc in (True, False):
        dl = tio.DataLoader(_Shards(), batch_size=2, num_workers=2,
                            use_process_workers=proc, places="cpu")
        vals = sorted(int(v) for b in dl for v in b.reshape(-1))
        # without process workers the reference iterates in-process, as
        # worker 0 of num_workers
        assert vals == (list(range(8)) if proc else list(range(0, 8, 2)))


def test_process_workers_fall_back_with_cuda_live(monkeypatch):
    """With CUDA initialized, ``use_process_workers=True`` warns and
    takes threads, as the reference does with a live accelerator; the
    automatic mode takes threads quietly."""
    from paddle_tpu_torch.io import dataloader as dlmod
    monkeypatch.setattr(dlmod.torch.cuda, "is_initialized", lambda: True)
    with pytest.warns(RuntimeWarning, match="falling back to thread"):
        rows = list(tio.DataLoader(_Items(), batch_size=5, num_workers=2,
                                   use_process_workers=True, places="cpu"))
    pids = {int(p) for b in rows for p in b[0][:, 1].tolist()}
    assert pids == {os.getpid()}
    dl = tio.DataLoader(_Items(), batch_size=5, num_workers=2, places="cpu")
    assert dl._resolve_process_workers() is False


def test_dataloader_needs_cuda_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tio.DataLoader(_Items(), batch_size=2)
    assert tio.DataLoader(_Items(), places=["cpu"]).device.type == "cpu"


def _tied_scores():
    p = np.array([[0.1, 0.5, 0.5, 0.2],       # tie between classes 1 and 2
                  [0.3, 0.3, 0.3, 0.3],       # all tied
                  [0.9, 0.1, 0.9, 0.0],
                  [0.0, 0.2, 0.7, 0.7]], np.float32)
    return p, np.array([[1], [3], [0], [2]], np.int64)


@pytest.mark.parametrize("topk", [(1,), (1, 2), (3,)])
def test_accuracy_on_tied_rows_matches_jax(topk):
    """Between tied scores the higher index ranks first in both
    packages (a stable ascending sort, reversed)."""
    p, l = _tied_scores()
    jm_, tm_ = jmetric.Accuracy(topk=topk), tmetric.Accuracy(topk=topk)
    for rows in (slice(0, 2), slice(2, 4)):
        jc = jm_.compute(jpaddle.to_tensor(p[rows]),
                         jpaddle.to_tensor(l[rows]))
        tc = tm_.compute(torch.tensor(p[rows]), torch.tensor(l[rows]))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc._value))
        assert tm_.update(tc) == jm_.update(jc)
    got, want = tm_.accumulate(), jm_.accumulate()
    assert got == want and tm_.name() == jm_.name()
    assert type(got if len(topk) == 1 else got[0]) is np.float64
    for k in topk:
        assert float(tmetric.accuracy(torch.tensor(p), torch.tensor(l),
                                      k=k)) == \
            float(jmetric.accuracy(jpaddle.to_tensor(p),
                                   jpaddle.to_tensor(l), k=k)._value)


def test_precision_recall_auc_match_jax():
    rng = np.random.default_rng(3)
    preds = rng.random(64).astype(np.float32)
    preds[::5] = 0.5                                  # ties at the cut
    labels = rng.integers(0, 2, 64)
    two_col = np.stack([1 - preds, preds], axis=1)
    for cls in ("Precision", "Recall", "Auc"):
        jm_, tm_ = getattr(jmetric, cls)(), getattr(tmetric, cls)()
        for half in (slice(0, 32), slice(32, 64)):
            p = two_col[half] if cls == "Auc" else preds[half]
            jm_.update(jpaddle.to_tensor(p), jpaddle.to_tensor(labels[half]))
            tm_.update(torch.tensor(p), torch.tensor(labels[half]))
        assert tm_.accumulate() == pytest.approx(jm_.accumulate(),
                                                 rel=1e-12)
        assert tm_.name() == jm_.name()


def test_save_load_cross_both_ways(tmp_path):
    """A file either package writes loads in the other: the envelope,
    its nesting and dtypes, bf16 as float32 data with the flag."""
    rng = np.random.default_rng(0)
    a32 = rng.standard_normal((3, 4)).astype(np.float32)
    a64 = rng.integers(0, 9, (5,)).astype(np.int64)
    bf = rng.standard_normal((2, 3)).astype(np.float32)
    tobj = {"w": torch.tensor(a32), "i": torch.tensor(a64),
            "b": torch.tensor(bf).to(torch.bfloat16),
            "nest": [torch.tensor(a32[0]), ("x", 3)], "lr": 0.5}
    p = str(tmp_path / "sub" / "port.pdparams")
    paddle.save(tobj, p)
    with open(p, "rb") as f:
        raw = pickle.load(f)
    assert raw["w"]["__paddle_tpu_tensor__"] is True
    assert raw["b"]["__bf16__"] is True and raw["b"]["data"].dtype == \
        np.float32
    j = jpaddle.load(p)
    np.testing.assert_array_equal(np.asarray(j["w"]._value), a32)
    np.testing.assert_array_equal(np.asarray(j["i"]._value),
                                  np.asarray(jpaddle.to_tensor(a64)._value))
    assert str(j["b"].dtype) == "bfloat16"
    np.testing.assert_array_equal(
        np.asarray(j["b"]._value.astype("float32")),
        tobj["b"].float().numpy())
    assert j["nest"][1] == ("x", 3) and j["lr"] == 0.5
    # the other way
    jobj = {"w": jpaddle.to_tensor(a32),
            "b": jpaddle.to_tensor(bf).astype("bfloat16"),
            "nest": [jpaddle.to_tensor(a32[1])], "step": 7}
    q = str(tmp_path / "jax.pdparams")
    jpaddle.save(jobj, q)
    t = paddle.load(q)
    assert isinstance(t["w"], torch.Tensor) and t["w"].device.type == "cpu"
    assert torch.equal(t["w"], torch.tensor(a32))
    assert t["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        t["b"].float().numpy(),
        np.asarray(jobj["b"]._value.astype("float32")))
    assert torch.equal(t["nest"][0], torch.tensor(a32[1]))
    assert t["step"] == 7


def test_save_load_optimizer_state_round_trip(tmp_path):
    net = paddle.nn.Linear(3, 2, device="cpu")
    opt = paddle.optimizer.Adam(parameters=net.parameters())
    net(torch.ones(2, 3)).sum().backward()
    opt.step()
    paddle.save(net.state_dict(), str(tmp_path / "m.pdparams"))
    paddle.save(opt.state_dict(), str(tmp_path / "m.pdopt"))
    net2 = paddle.nn.Linear(3, 2, device="cpu")
    net2.load_state_dict(paddle.load(str(tmp_path / "m.pdparams")))
    assert torch.equal(net2.weight, net.weight)
    opt2 = paddle.optimizer.Adam(parameters=net2.parameters())
    opt2.set_state_dict(paddle.load(str(tmp_path / "m.pdopt")))
    got, want = opt2.state_dict(), opt.state_dict()
    assert sorted(got) == sorted(want) and got
    for k in want:
        assert torch.equal(got[k], want[k]), k
