"""paddle.metric's classes (counterpart of
``paddle_tpu/metric/metrics.py``): ``Metric`` with compute, update,
accumulate, reset and name, and Accuracy, Precision, Recall and Auc.
They accumulate on the host over fetched numpy arrays, so the step
keeps no scalar bookkeeping on the card.
"""
from __future__ import annotations

import numpy as np


class Metric:
    """The base class."""

    def __init__(self, name=None):
        self._name = name or self.__class__.__name__.lower()

    def reset(self):
        raise NotImplementedError

    def compute(self, *args):
        """Optional device-side pre-step; default passthrough."""
        return args

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        return self._name


class Accuracy(Metric):
    """Top-k accuracy."""

    def __init__(self, topk=(1,), name=None):
        super().__init__(name or "acc")
        self.topk = tuple(topk) if isinstance(topk, (tuple, list)) else (topk,)
        self.reset()

    def reset(self):
        self.total = np.zeros(len(self.topk))
        self.count = np.zeros(len(self.topk))

    def compute(self, pred, label):
        pred = np.asarray(pred)
        label = np.asarray(label).reshape(-1)
        kmax = max(self.topk)
        top = np.argsort(-pred, axis=-1)[..., :kmax]
        correct = (top == label[:, None])
        return correct

    def update(self, correct):
        correct = np.asarray(correct)
        res = []
        for i, k in enumerate(self.topk):
            c = correct[..., :k].any(axis=-1).astype(np.float64)
            self.total[i] += c.sum()
            self.count[i] += c.size
            res.append(c.mean() if c.size else 0.0)
        return res[0] if len(res) == 1 else res

    def accumulate(self):
        acc = np.where(self.count > 0, self.total / np.maximum(self.count, 1),
                       0.0)
        return float(acc[0]) if len(self.topk) == 1 else [float(a)
                                                          for a in acc]


class Precision(Metric):
    """Binary precision: tp / (tp + fp)."""

    def __init__(self, name=None):
        super().__init__(name or "precision")
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = (np.asarray(preds).reshape(-1) > 0.5).astype(np.int64)
        labels = np.asarray(labels).reshape(-1).astype(np.int64)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fp += int(((preds == 1) & (labels == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return float(self.tp) / denom if denom else 0.0


class Recall(Metric):
    """Binary recall: tp / (tp + fn)."""

    def __init__(self, name=None):
        super().__init__(name or "recall")
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = (np.asarray(preds).reshape(-1) > 0.5).astype(np.int64)
        labels = np.asarray(labels).reshape(-1).astype(np.int64)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fn += int(((preds == 0) & (labels == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return float(self.tp) / denom if denom else 0.0


class Auc(Metric):
    """ROC AUC over a histogram of the predictions (the auc op's
    algorithm)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name=None):
        super().__init__(name or "auc")
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        preds = np.asarray(preds)
        if preds.ndim == 2 and preds.shape[1] == 2:
            preds = preds[:, 1]
        preds = preds.reshape(-1)
        labels = np.asarray(labels).reshape(-1)
        idx = np.clip((preds * self.num_thresholds).astype(np.int64), 0,
                      self.num_thresholds)
        np.add.at(self._stat_pos, idx, labels == 1)
        np.add.at(self._stat_neg, idx, labels == 0)

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        # trapezoidal area walking thresholds high->low, anchored at (0,0)
        # so the first (highest-threshold) bucket's area is counted —
        # all-one-bucket degenerate input then yields 0.5, not 0.0
        pos = np.cumsum(self._stat_pos[::-1])
        neg = np.cumsum(self._stat_neg[::-1])
        tpr = np.concatenate([[0.0], pos / tot_pos])
        fpr = np.concatenate([[0.0], neg / tot_neg])
        return float(np.sum((fpr[1:] - fpr[:-1]) * (tpr[1:] + tpr[:-1]))
                     / 2)
