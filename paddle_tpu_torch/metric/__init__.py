"""paddle_tpu_torch.metric: port of ``paddle_tpu/metric/__init__.py``.

``accuracy`` and ``Accuracy.compute`` rank on the predictions' device
with the reference's tie rule: ``argsort(...)[..., ::-1]``, a stable
ascending sort reversed, so between tied scores the higher index ranks
first (``torch.topk`` promises no order among ties).  ``update`` reads
the correct-mask to the host (one device-to-host copy a batch) and
accumulates in numpy, so ``Accuracy.accumulate`` returns the
reference's ``np.float64``.  ``Precision``, ``Recall`` and ``Auc`` are
host numpy, as in the reference; ``Auc`` integrates with
``np.trapezoid`` where numpy has it (numpy 2 deprecates ``np.trapz``).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]

_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def _as_tensor(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


def _host(x) -> np.ndarray:
    """A tensor or array as a host numpy array (bf16 read as float32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def _topk_desc(p, k):
    """The reference's ``argsort(p)[..., ::-1][..., :k]``."""
    return torch.argsort(p, dim=-1, stable=True).flip(-1)[..., :k]


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    probs, lbl = _as_tensor(input), _as_tensor(label)
    if lbl.ndim == probs.ndim:
        lbl = lbl.reshape(lbl.shape[:-1])
    hit = (_topk_desc(probs, k) == lbl[..., None]).any(dim=-1)
    return hit.float().mean()


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self._name = name or "acc"
        self.maxk = max(self.topk)
        self.reset()

    def compute(self, pred, label, *args):
        p, l = _as_tensor(pred), _as_tensor(label)
        if l.ndim == p.ndim:
            l = l[..., 0]
        return (_topk_desc(p, self.maxk) == l[..., None]).float()

    def update(self, correct, *args):
        c = _host(correct)
        num = c.shape[0]
        for i, k in enumerate(self.topk):
            self.total[i] += np.any(c[..., :k], axis=-1).sum()
        self.count += num
        accs = [self.total[i] / max(self.count, 1)
                for i in range(len(self.topk))]
        return accs[0] if len(accs) == 1 else accs

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = 0

    def accumulate(self):
        accs = [t / max(self.count, 1) for t in self.total]
        return accs[0] if len(accs) == 1 else accs

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name=None):
        self._name = name or "precision"
        self.reset()

    def update(self, preds, labels):
        p = (_host(preds) > 0.5).astype(np.int32).reshape(-1)
        l = _host(labels).astype(np.int32).reshape(-1)
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fp += int(((p == 1) & (l == 0)).sum())

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name=None):
        self._name = name or "recall"
        self.reset()

    def update(self, preds, labels):
        p = (_host(preds) > 0.5).astype(np.int32).reshape(-1)
        l = _host(labels).astype(np.int32).reshape(-1)
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fn += int(((p == 0) & (l == 1)).sum())

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name=None):
        self._name = name or "auc"
        self.num_thresholds = num_thresholds
        self.reset()

    def update(self, preds, labels):
        p, l = _host(preds), _host(labels)
        if p.ndim == 2:
            p = p[:, 1]
        p = p.reshape(-1)
        l = l.reshape(-1)
        bins = np.minimum((p * self.num_thresholds).astype(np.int64),
                          self.num_thresholds - 1)
        for b, y in zip(bins, l):
            if y:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds, dtype=np.int64)
        self._stat_neg = np.zeros(self.num_thresholds, dtype=np.int64)

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if not tot_pos or not tot_neg:
            return 0.0
        # trapezoid over thresholds from high to low
        pos = np.cumsum(self._stat_pos[::-1])
        neg = np.cumsum(self._stat_neg[::-1])
        tpr = pos / tot_pos
        fpr = neg / tot_neg
        return float(_trapezoid(tpr, fpr))

    def name(self):
        return self._name
