"""DataLoader: port of ``paddle_tpu/io/dataloader.py``.

Host pipeline with the reference's two worker modes
(``_DataLoaderIterSingleProcess`` / ``_DataLoaderIterMultiProcess``):

- process mode: forked worker processes with per-worker index queues
  (round-robin), one shared result queue, a reorder buffer on the
  consumer and exit-code polling, so a dead worker raises instead of
  hanging.  A forked child only fetches and collates (numpy, or torch
  tensors on the CPU); it never touches CUDA.  Forking is safe only while
  CUDA is not initialized in this process (``torch.cuda.
  is_initialized()``, the reference's test of a live non-CPU backend):
  the mode is automatic then (``use_process_workers=None``); ``True``
  asks for it and, with CUDA live, warns and takes threads, as the
  reference's ``_resolve_process_workers`` does; ``False`` takes threads.
- thread mode: worker threads on ``runtime.WorkQueue``, their batches
  bounded by ``runtime.BlockingQueue`` (the reference's native pair runs
  the same protocol).

The consumer turns each batch into torch tensors on the loader's device
(the reference's ``_to_tensor``): ``places=None`` is the CUDA card (the
loader raises without CUDA, as every entry point does), ``places="cpu"``
keeps batches on the host.  A batch reaches the card from pinned memory
with ``non_blocking=True``.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import threading
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from ..device import resolve_device
from .dataset import IterableDataset
from .sampler import BatchSampler

__all__ = ["DataLoader", "default_collate_fn", "get_worker_info"]

_worker_info = threading.local()


def _fork_is_safe():
    """True while CUDA is not initialized in this process: a child forked
    with a live CUDA context cannot use it and may deadlock."""
    return not torch.cuda.is_initialized()


def get_worker_info():
    return getattr(_worker_info, "info", None)


class WorkerInfo:
    def __init__(self, id, num_workers, dataset):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


class _WorkerError:
    """Picklable error marker crossing the process boundary."""

    def __init__(self, msg):
        self.msg = msg


class _WorkerDone:
    def __init__(self, wid):
        self.wid = wid


def default_collate_fn(batch):
    """Stack samples into batched numpy arrays (mirrors the reference's
    default_collate_fn field-wise recursion)."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, dtype=np.int64)
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, dtype=np.float32)
    if isinstance(sample, (str, bytes)):
        return list(batch)
    if isinstance(sample, dict):
        return {k: default_collate_fn([d[k] for d in batch]) for k in sample}
    if isinstance(sample, (tuple, list)):
        transposed = list(zip(*batch))
        return type(sample)(default_collate_fn(list(f)) for f in transposed)
    return np.asarray(batch)


def _to_tensor(value, device):
    """numpy arrays and CPU tensors of a batch as tensors on ``device``:
    to the card from pinned memory, without blocking the host."""
    if isinstance(value, np.ndarray):
        value = torch.from_numpy(value)
    if isinstance(value, torch.Tensor):
        if device.type == "cpu" or value.device == device:
            return value
        return value.pin_memory().to(device, non_blocking=True)
    if isinstance(value, dict):
        return {k: _to_tensor(v, device) for k, v in value.items()}
    if isinstance(value, (tuple, list)):
        return type(value)(_to_tensor(v, device) for v in value)
    return value


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, use_process_workers=None):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = max(prefetch_factor, 2)
        self.worker_init_fn = worker_init_fn
        self.timeout = timeout or None
        self.use_process_workers = use_process_workers
        if isinstance(places, (list, tuple)):
            places = places[0] if places else None
        self.device = resolve_device(places)
        self._iterable = isinstance(dataset, IterableDataset)
        if self._iterable:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)

    def __len__(self):
        if self._iterable:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)

    def _fetch(self, indices):
        batch = [self.dataset[i] for i in indices]
        return self.collate_fn(batch)

    def _iter_iterable(self):
        _worker_info.info = WorkerInfo(0, max(self.num_workers, 1), self.dataset)
        batch = []
        for sample in self.dataset:
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield _to_tensor(self.collate_fn(batch), self.device)
                batch = []
        if batch and not self.drop_last:
            yield _to_tensor(self.collate_fn(batch), self.device)

    def _iter_sync(self):
        for indices in self.batch_sampler:
            yield _to_tensor(self._fetch(indices), self.device)

    def _iter_workers(self):
        # the prefetch pipeline: a BlockingQueue bounds the batches in
        # flight and a WorkQueue thread pool runs the fetch+collate tasks
        from .. import runtime as rt

        out_q = rt.BlockingQueue(self.prefetch_factor * self.num_workers)
        idx_q: "queue.Queue" = queue.Queue()
        batches = list(self.batch_sampler)
        for i, b in enumerate(batches):
            idx_q.put((i, b))
        n_batches = len(batches)
        pool = rt.WorkQueue(self.num_workers)

        def worker(wid):
            # every failure mode (init fn, fetch, collate) is surfaced to the
            # consumer through the queue so the iterator never hangs silently
            try:
                _worker_info.info = WorkerInfo(wid, self.num_workers,
                                               self.dataset)
                if self.worker_init_fn is not None:
                    self.worker_init_fn(wid)
            except Exception as e:
                try:
                    i, _ = idx_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    out_q.push((i, e))
                except rt.QueueClosed:
                    pass
                return
            while not out_q.closed:
                try:
                    i, indices = idx_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    item = (i, self._fetch(indices))
                except Exception as e:  # surface worker errors to the consumer
                    item = (i, e)
                try:
                    out_q.push(item)
                except rt.QueueClosed:
                    return

        for w in range(self.num_workers):
            pool.submit(lambda w=w: worker(w))
        try:
            # reorder to preserve batch order
            pending = {}
            next_idx = 0
            received = 0
            while received < n_batches:
                i, data = out_q.pop(timeout=self.timeout)
                received += 1
                pending[i] = data
                while next_idx in pending:
                    item = pending.pop(next_idx)
                    next_idx += 1
                    if isinstance(item, Exception):
                        raise item
                    yield _to_tensor(item, self.device)
        finally:
            out_q.close()
            pool.shutdown()

    def _iter_multiprocess(self):
        """Forked worker processes (reference _DataLoaderIterMultiProcess,
        dataloader_iter.py:358): per-worker index queues assigned
        round-robin (deterministic), one shared result queue, a reorder
        buffer on the consumer, and liveness polling so a dead worker
        raises instead of hanging the iterator."""
        ctx = mp.get_context("fork")
        batches = list(self.batch_sampler)
        n_batches = len(batches)
        nw = self.num_workers
        index_queues = [ctx.Queue() for _ in range(nw)]
        result_q = ctx.Queue(maxsize=self.prefetch_factor * nw)
        for i, b in enumerate(batches):
            index_queues[i % nw].put((i, list(b)))
        for q in index_queues:
            q.put(None)  # sentinel: no more work

        dataset = self.dataset
        collate = self.collate_fn
        init_fn = self.worker_init_fn

        def worker_main(wid, idx_q, out_q):
            try:
                _worker_info.info = WorkerInfo(wid, nw, dataset)
                if init_fn is not None:
                    init_fn(wid)
                while True:
                    task = idx_q.get()
                    if task is None:
                        break
                    i, indices = task
                    try:
                        data = collate([dataset[j] for j in indices])
                    except Exception as e:  # surface to the consumer
                        data = _WorkerError(repr(e))
                    out_q.put((i, data))
            except KeyboardInterrupt:
                # dying mid-write: don't block process exit on the feeder
                out_q.cancel_join_thread()

        procs = []
        for w in range(nw):
            p = ctx.Process(target=worker_main,
                            args=(w, index_queues[w], result_q),
                            daemon=True)
            p.start()
            procs.append(p)

        try:
            pending = {}
            next_idx = 0
            received = 0
            while received < n_batches:
                try:
                    i, data = result_q.get(timeout=self.timeout or 5.0)
                except queue.Empty:
                    # normal exit (exitcode 0) is not death: a finished
                    # worker may coexist with a slow one mid-epoch
                    crashed = [p.pid for p in procs
                               if p.exitcode not in (None, 0)]
                    if crashed:
                        raise RuntimeError(
                            f"DataLoader worker(s) {crashed} exited "
                            "unexpectedly") from None
                    if all(p.exitcode == 0 for p in procs):
                        raise RuntimeError(
                            "DataLoader workers all finished but "
                            f"{n_batches - received} batch(es) were never "
                            "received") from None
                    if self.timeout:
                        raise RuntimeError(
                            f"DataLoader timed out after {self.timeout}s "
                            "waiting for a batch") from None
                    continue
                received += 1
                pending[i] = data
                while next_idx in pending:
                    item = pending.pop(next_idx)
                    next_idx += 1
                    if isinstance(item, _WorkerError):
                        raise RuntimeError(
                            f"DataLoader worker raised: {item.msg}")
                    yield _to_tensor(item, self.device)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=1.0)
            for q in index_queues:
                q.cancel_join_thread()
                q.close()
            result_q.cancel_join_thread()
            result_q.close()

    def _resolve_process_workers(self):
        """Process workers only while CUDA is not initialized here.
        use_process_workers None=auto, True=requested (falls back with a
        warning when unsafe), False=threads."""
        if self.use_process_workers is False:
            return False
        safe = _fork_is_safe()
        if self.use_process_workers and not safe:
            fallback = ("sequential in-process iteration" if self._iterable
                        else "thread workers")
            warnings.warn(
                "DataLoader(use_process_workers=True) but CUDA is already "
                "initialized in this process; forking now is unsafe — "
                f"falling back to {fallback}.",
                RuntimeWarning)
        return safe

    def __iter__(self):
        use_proc = self.num_workers > 0 and self._resolve_process_workers()
        if self._iterable:
            if use_proc:
                return self._iter_iterable_multiprocess()
            return self._iter_iterable()
        if self.num_workers > 0:
            if use_proc:
                return self._iter_multiprocess()
            return self._iter_workers()
        return self._iter_sync()

    def _iter_iterable_multiprocess(self):
        """IterableDataset over forked workers: each worker iterates its
        shard (WorkerInfo tells it which), builds whole batches, and the
        consumer yields them in arrival order (the reference likewise
        leaves cross-worker order undefined for iterable datasets)."""
        ctx = mp.get_context("fork")
        nw = self.num_workers
        result_q = ctx.Queue(maxsize=self.prefetch_factor * nw)
        dataset = self.dataset
        collate = self.collate_fn
        init_fn = self.worker_init_fn
        batch_size = self.batch_size
        drop_last = self.drop_last

        def worker_main(wid, out_q):
            try:
                _worker_info.info = WorkerInfo(wid, nw, dataset)
                if init_fn is not None:
                    init_fn(wid)
                batch = []
                try:
                    for sample in dataset:
                        batch.append(sample)
                        if len(batch) == batch_size:
                            out_q.put(collate(batch))
                            batch = []
                    if batch and not drop_last:
                        out_q.put(collate(batch))
                except Exception as e:
                    out_q.put(_WorkerError(repr(e)))
                out_q.put(_WorkerDone(wid))
            except KeyboardInterrupt:
                # dying mid-write: don't block process exit on the feeder
                out_q.cancel_join_thread()

        procs = []
        for w in range(nw):
            p = ctx.Process(target=worker_main, args=(w, result_q),
                            daemon=True)
            p.start()
            procs.append(p)

        try:
            done = 0
            while done < nw:
                try:
                    item = result_q.get(timeout=self.timeout or 5.0)
                except queue.Empty:
                    crashed = [p.pid for p in procs
                               if p.exitcode not in (None, 0)]
                    if crashed:
                        raise RuntimeError(
                            f"DataLoader worker(s) {crashed} exited "
                            "unexpectedly") from None
                    continue
                if isinstance(item, _WorkerDone):
                    done += 1
                    continue
                if isinstance(item, _WorkerError):
                    raise RuntimeError(
                        f"DataLoader worker raised: {item.msg}")
                yield _to_tensor(item, self.device)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=1.0)
            result_q.cancel_join_thread()
            result_q.close()
