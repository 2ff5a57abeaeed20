"""Streaming metrics on the host (counterpart of
``paddle_tpu/fluid/metrics.py``): numpy accumulators over fetched
values."""
from __future__ import annotations

import numpy as np


class MetricBase:
    def __init__(self, name=None):
        self._name = name or type(self).__name__

    def reset(self):
        raise NotImplementedError

    def update(self, *a, **k):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class Accuracy(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight=1):
        self.value += float(np.asarray(value).reshape(-1)[0]) * weight
        self.weight += weight

    def eval(self):
        return self.value / max(self.weight, 1e-12)


class Auc(MetricBase):
    def __init__(self, name=None, curve="ROC", num_thresholds=4095):
        super().__init__(name)
        self._num = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self._num + 1)
        self._stat_neg = np.zeros(self._num + 1)

    def update(self, preds, labels):
        preds = np.asarray(preds)
        labels = np.asarray(labels).reshape(-1)
        p1 = preds[:, -1] if preds.ndim > 1 else preds
        idx = np.clip((p1 * self._num).astype(int), 0, self._num)
        np.add.at(self._stat_pos, idx, labels)
        np.add.at(self._stat_neg, idx, 1 - labels)

    def eval(self):
        tp = np.cumsum(self._stat_pos[::-1])
        fp = np.cumsum(self._stat_neg[::-1])
        tot_p, tot_n = tp[-1], fp[-1]
        if tot_p * tot_n == 0:
            return 0.0
        tp_prev = np.concatenate([[0], tp[:-1]])
        fp_prev = np.concatenate([[0], fp[:-1]])
        return float(np.sum((fp - fp_prev) * (tp + tp_prev) / 2)
                     / (tot_p * tot_n))


class ChunkEvaluator(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.num_infer = self.num_label = self.num_correct = 0

    def update(self, num_infer_chunks, num_label_chunks, num_correct_chunks):
        self.num_infer += int(num_infer_chunks)
        self.num_label += int(num_label_chunks)
        self.num_correct += int(num_correct_chunks)

    def eval(self):
        precision = self.num_correct / max(self.num_infer, 1)
        recall = self.num_correct / max(self.num_label, 1)
        f1 = 2 * precision * recall / max(precision + recall, 1e-12)
        return precision, recall, f1


class CompositeMetric(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        self._metrics.append(metric)

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


class Precision(MetricBase):
    """Binary precision over accumulated predictions (metrics.py:Precision)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fp = 0

    def reset(self):
        self.tp = self.fp = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype("int64").ravel()
        labels = np.asarray(labels).astype("int64").ravel()
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fp += int(np.sum((preds == 1) & (labels == 0)))

    def eval(self):
        denom = self.tp + self.fp
        return float(self.tp) / denom if denom else 0.0


class Recall(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fn = 0

    def reset(self):
        self.tp = self.fn = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype("int64").ravel()
        labels = np.asarray(labels).astype("int64").ravel()
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fn += int(np.sum((preds == 0) & (labels == 1)))

    def eval(self):
        denom = self.tp + self.fn
        return float(self.tp) / denom if denom else 0.0


class EditDistance(MetricBase):
    """Average edit distance + instance error rate (metrics.py:EditDistance);
    pairs with layers.edit_distance outputs."""

    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        d = np.asarray(distances, "float32").ravel()
        self.total_distance += float(d.sum())
        self.seq_num += int(seq_num)
        self.instance_error += int(np.sum(d > 0))

    def eval(self):
        if self.seq_num == 0:
            raise ValueError("EditDistance.eval before any update")
        return (self.total_distance / self.seq_num,
                self.instance_error / self.seq_num)


class DetectionMAP(MetricBase):
    """mean Average Precision accumulator (metrics.py:DetectionMAP); the
    in-graph companion op is layers.detection_map."""

    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self._vals = []

    def update(self, value, weight=1):
        self._vals.append((float(np.asarray(value).ravel()[0]),
                           float(weight)))

    def get_map_var(self):
        return None

    def eval(self):
        if not self._vals:
            raise ValueError("DetectionMAP.eval before any update")
        num = sum(v * w for v, w in self._vals)
        den = sum(w for _, w in self._vals)
        return num / max(den, 1e-12)
