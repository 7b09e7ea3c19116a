"""``paddle.metric``.

Counterpart: ``paddle_tpu/metric/__init__.py``: ``Metric``,
``Accuracy`` (top-k), ``Precision``, ``Recall``, ``Auc`` (threshold
buckets) and the functional ``accuracy``. They accumulate on the host in
numpy, as the reference's do: each ``update`` reads its inputs from the
device once.
"""
from __future__ import annotations

import abc

import numpy as np

import torch

from ..core.tensor import to_plain

__all__ = ["Accuracy", "Auc", "Metric", "Precision", "Recall", "accuracy"]


def _np(x):
    if isinstance(x, torch.Tensor):
        x = to_plain(x).detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


class Metric(abc.ABC):
    """Parity: paddle.metric.Metric base."""

    def __init__(self):
        pass

    @abc.abstractmethod
    def reset(self):
        ...

    @abc.abstractmethod
    def update(self, *args):
        ...

    @abc.abstractmethod
    def accumulate(self):
        ...

    @abc.abstractmethod
    def name(self):
        ...

    def compute(self, *args):
        return args


class Accuracy(Metric):
    """Parity: paddle.metric.Accuracy (top-k)."""

    def __init__(self, topk=(1,), name=None):
        super().__init__()
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label, *args):
        pred = _np(pred)
        label = _np(label)
        if label.ndim == pred.ndim and label.shape[-1] == 1:
            label = label[..., 0]
        topk_idx = np.argsort(-pred, axis=-1)[..., :self.maxk]
        correct = (topk_idx == label[..., None]).astype(np.float32)
        return correct

    def update(self, correct, *args):
        correct = _np(correct)
        num = correct.shape[0] if correct.ndim else 1
        accs = []
        for k in self.topk:
            c = correct[..., :k].sum()
            self.total[self.topk.index(k)] += c
            accs.append(c / max(num, 1))
        self.count += num
        return accs[0] if len(accs) == 1 else accs

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = 0

    def accumulate(self):
        res = [t / max(self.count, 1) for t in self.total]
        return res[0] if len(res) == 1 else res

    def name(self):
        return self._name


class Precision(Metric):
    """Binary precision. Parity: paddle.metric.Precision."""

    def __init__(self, name="precision"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = (_np(preds) > 0.5).astype(np.int64).ravel()
        labels = _np(labels).astype(np.int64).ravel()
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fp += int(((preds == 1) & (labels == 0)).sum())

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        return self.tp / max(self.tp + self.fp, 1)

    def name(self):
        return self._name


class Recall(Metric):
    """Binary recall. Parity: paddle.metric.Recall."""

    def __init__(self, name="recall"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = (_np(preds) > 0.5).astype(np.int64).ravel()
        labels = _np(labels).astype(np.int64).ravel()
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fn += int(((preds == 0) & (labels == 1)).sum())

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        return self.tp / max(self.tp + self.fn, 1)

    def name(self):
        return self._name


class Auc(Metric):
    """ROC AUC via threshold bucketing. Parity: paddle.metric.Auc."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        super().__init__()
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def update(self, preds, labels):
        preds = _np(preds)
        if preds.ndim == 2:
            preds = preds[:, -1]
        labels = _np(labels).ravel()
        idx = np.clip((preds.ravel() * self.num_thresholds).astype(np.int64),
                      0, self.num_thresholds)
        for i, l in zip(idx, labels):
            if l:
                self._stat_pos[i] += 1
            else:
                self._stat_neg[i] += 1

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        # integrate TPR over FPR from the highest threshold down
        pos = self._stat_pos[::-1].cumsum()
        neg = self._stat_neg[::-1].cumsum()
        tpr = pos / tot_pos
        fpr = neg / tot_neg
        trapezoid = getattr(np, "trapezoid", None) or np.trapz
        return float(trapezoid(tpr, fpr))

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):  # noqa: A002
    """Functional top-k accuracy. Parity: paddle.metric.accuracy."""
    from ..ops import to_tensor
    pred = _np(input)
    lab = _np(label)
    if lab.ndim == pred.ndim and lab.shape[-1] == 1:
        lab = lab[..., 0]
    topk_idx = np.argsort(-pred, axis=-1)[..., :k]
    corr = (topk_idx == lab[..., None]).any(-1).mean()
    place = input.device if isinstance(input, torch.Tensor) else None
    return to_tensor(np.asarray(corr, np.float32), place=place)
