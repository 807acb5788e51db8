"""Evaluation metrics (counterpart of ``mxnet_tpu/metric.py``): the same
metrics, computed on the host from ``asnumpy()`` copies."""
from __future__ import annotations

import numpy as np

from .ndarray import NDArray

__all__ = ["EvalMetric", "Accuracy", "TopKAccuracy", "CrossEntropy", "Perplexity",
           "F1", "MCC", "NegativeLogLikelihood", "MAE", "MSE", "RMSE",
           "PearsonCorrelation", "Loss", "CompositeEvalMetric",
           "MApMetric", "VOC07MApMetric", "create"]

_REGISTRY = {}


def register(cls):
    _REGISTRY[cls.__name__.lower()] = cls
    return cls


def create(metric, *args, **kwargs):
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, (list, tuple)):
        c = CompositeEvalMetric()
        for m in metric:
            c.add(create(m, *args, **kwargs))
        return c
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    name = metric.lower()
    aliases = {"acc": "accuracy", "top_k_accuracy": "topkaccuracy",
               "top_k_acc": "topkaccuracy", "ce": "crossentropy",
               "pearsonr": "pearsoncorrelation"}
    name = aliases.get(name, name)
    if name not in _REGISTRY:
        raise ValueError(f"unknown metric {metric!r}")
    return _REGISTRY[name](*args, **kwargs)


def _np(x):
    return x.asnumpy() if isinstance(x, NDArray) else np.asarray(x)


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = name
        self.output_names = output_names
        self.label_names = label_names
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        raise NotImplementedError

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, self.sum_metric / self.num_inst

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name, value = [name], [value]
        return list(zip(name, value))

    def update_dict(self, labels, preds):
        self.update(list(labels.values()), list(preds.values()))

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


@register
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", **kwargs):
        super().__init__(name, **kwargs)
        self.axis = axis

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred, label = _np(pred), _np(label)
            if pred.ndim > label.ndim:
                pred = pred.argmax(axis=self.axis)
            pred = pred.astype(np.int64).reshape(-1)
            label = label.astype(np.int64).reshape(-1)
            self.sum_metric += (pred == label).sum()
            self.num_inst += len(label)


@register
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", **kwargs):
        super().__init__(f"{name}_{top_k}", **kwargs)
        self.top_k = top_k

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred, label = _np(pred), _np(label).astype(np.int64).reshape(-1)
            topk = np.argsort(-pred, axis=-1)[:, : self.top_k]
            self.sum_metric += (topk == label[:, None]).any(axis=1).sum()
            self.num_inst += len(label)


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", **kwargs):
        super().__init__(name, **kwargs)
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred, label = _np(pred), _np(label).astype(np.int64).reshape(-1)
            p = pred.reshape(-1, pred.shape[-1])[np.arange(len(label)), label]
            self.sum_metric += (-np.log(p + self.eps)).sum()
            self.num_inst += len(label)


@register
class Perplexity(CrossEntropy):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity", **kwargs):
        super().__init__(name=name, **kwargs)
        self.ignore_label = ignore_label

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred, label = _np(pred), _np(label).astype(np.int64).reshape(-1)
            p = pred.reshape(-1, pred.shape[-1])[np.arange(len(label)), label]
            nll = -np.log(np.maximum(p, 1e-12))
            if self.ignore_label is not None:
                keep = label != self.ignore_label
                nll, cnt = nll[keep], keep.sum()
            else:
                cnt = len(label)
            self.sum_metric += nll.sum()
            self.num_inst += int(cnt)

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, float(np.exp(self.sum_metric / self.num_inst))


@register
class F1(EvalMetric):
    def __init__(self, name="f1", average="macro", **kwargs):
        super().__init__(name, **kwargs)
        self.average = average
        self.reset_stats()

    def reset_stats(self):
        self.tp = self.fp = self.fn = 0

    def reset(self):
        super().reset()
        if hasattr(self, "tp"):
            self.reset_stats()

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred, label = _np(pred), _np(label).reshape(-1).astype(np.int64)
            if pred.ndim > 1:
                pred = pred.argmax(axis=-1)
            pred = pred.reshape(-1).astype(np.int64)
            self.tp += int(((pred == 1) & (label == 1)).sum())
            self.fp += int(((pred == 1) & (label == 0)).sum())
            self.fn += int(((pred == 0) & (label == 1)).sum())
            self.num_inst += len(label)

    def get(self):
        prec = self.tp / max(self.tp + self.fp, 1)
        rec = self.tp / max(self.tp + self.fn, 1)
        f1 = 2 * prec * rec / max(prec + rec, 1e-12)
        return self.name, f1


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred, label = _np(pred), _np(label)
            self.sum_metric += np.abs(label.reshape(pred.shape) - pred).mean() * len(pred)
            self.num_inst += len(pred)


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred, label = _np(pred), _np(label)
            self.sum_metric += ((label.reshape(pred.shape) - pred) ** 2).mean() * len(pred)
            self.num_inst += len(pred)


@register
class RMSE(MSE):
    def __init__(self, name="rmse", **kwargs):
        super().__init__(name=name, **kwargs)

    def get(self):
        name, mse = super().get()
        return name, float(np.sqrt(mse))


@register
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", **kwargs):
        super().__init__(name, **kwargs)
        self._preds, self._labels = [], []

    def reset(self):
        super().reset()
        self._preds, self._labels = [], []

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            self._preds.append(_np(pred).reshape(-1))
            self._labels.append(_np(label).reshape(-1))
            self.num_inst += len(self._preds[-1])

    def get(self):
        if not self._preds:
            return self.name, float("nan")
        p = np.concatenate(self._preds)
        l = np.concatenate(self._labels)
        return self.name, float(np.corrcoef(p, l)[0, 1])


@register
class Loss(EvalMetric):
    def __init__(self, name="loss", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, _, preds):
        for pred in _as_list(preds):
            v = _np(pred)
            self.sum_metric += float(v.sum())
            self.num_inst += v.size


class CustomMetric(EvalMetric):
    def __init__(self, feval, name="custom", allow_extra_outputs=False, **kwargs):
        super().__init__(name, **kwargs)
        self._feval = feval

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            v = self._feval(_np(label), _np(pred))
            if isinstance(v, tuple):
                s, n = v
                self.sum_metric += s
                self.num_inst += n
            else:
                self.sum_metric += v
                self.num_inst += 1


@register
class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", **kwargs):
        super().__init__(name, **kwargs)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names.append(n)
            values.append(v)
        return names, values


def _box_iou(a, b):
    """IoU of one box [l,t,r,b] against (N,4) boxes."""
    il = np.maximum(a[0], b[:, 0])
    it = np.maximum(a[1], b[:, 1])
    ir = np.minimum(a[2], b[:, 2])
    ib = np.minimum(a[3], b[:, 3])
    iw = np.maximum(ir - il, 0.0)
    ih = np.maximum(ib - it, 0.0)
    inter = iw * ih
    area_a = max(a[2] - a[0], 0.0) * max(a[3] - a[1], 0.0)
    area_b = np.maximum(b[:, 2] - b[:, 0], 0.0) * \
        np.maximum(b[:, 3] - b[:, 1], 0.0)
    union = area_a + area_b - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


@register
class MApMetric(EvalMetric):
    """Detection mean Average Precision (reference
    example/ssd/evaluate/eval_metric.py::MApMetric).

    update(labels, preds):
      preds:  (B, N, 6) rows [cls_id, score, l, t, r, b] — the
              MultiBoxDetection / box_nms output; cls_id < 0 = invalid.
      labels: (B, M, 5+) rows [cls_id, l, t, r, b, (difficult)]; cls_id < 0
              pads.
    AP integration is area-under-PR (VOC 2010+); VOC07MApMetric overrides
    with the 11-point interpolation the reference publishes VOC07 mAP with.
    """

    def __init__(self, ovp_thresh=0.5, use_difficult=False, class_names=None,
                 pred_idx=0, name="mAP", **kwargs):
        self.ovp_thresh = float(ovp_thresh)
        self.use_difficult = bool(use_difficult)
        self.class_names = list(class_names) if class_names else None
        self.pred_idx = int(pred_idx)
        super().__init__(name, **kwargs)

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        # per-class: list of (score, is_tp) + ground-truth counts
        self._records = {}
        self._gt_counts = {}

    def update(self, labels, preds):
        labels = _as_list(labels)
        preds = _as_list(preds)
        pred = _np(preds[self.pred_idx])
        label = _np(labels[0])
        assert pred.ndim == 3 and pred.shape[-1] >= 6, \
            f"preds must be (B,N,6) detection rows, got {pred.shape}"
        for b in range(pred.shape[0]):
            self._update_one(label[b], pred[b])
        self.num_inst += 1

    def _update_one(self, gts, dets):
        gts = gts[gts[:, 0] >= 0]
        difficult = (gts[:, 5] > 0 if gts.shape[-1] > 5
                     else np.zeros(len(gts), bool))
        for c in np.unique(gts[:, 0]).astype(int):
            n_easy = int(((gts[:, 0] == c) & ~difficult).sum())
            self._gt_counts[c] = self._gt_counts.get(c, 0) + n_easy
        dets = dets[dets[:, 0] >= 0]
        dets = dets[np.argsort(-dets[:, 1])]  # score desc: greedy matching
        matched = np.zeros(len(gts), bool)
        for row in dets:
            c = int(row[0])
            rec = self._records.setdefault(c, [])
            # VOC devkit semantics: argmax IoU over ALL GTs of the class
            # (matched ones included) — a duplicate of an already-matched
            # GT is an FP, it must NOT fall back to the second-best GT
            cand = np.where(gts[:, 0] == c)[0]
            if len(cand) == 0:
                rec.append((float(row[1]), 0))
                continue
            ious = _box_iou(row[2:6], gts[cand, 1:5])
            j = int(np.argmax(ious))
            if ious[j] >= self.ovp_thresh:
                gi = cand[j]
                if difficult[gi] and not self.use_difficult:
                    # VOC devkit: a difficult match is ignored (not tp, not
                    # fp) and the difficult GT is NEVER consumed — later
                    # detections may still match it and be ignored too
                    continue
                if matched[gi]:
                    rec.append((float(row[1]), 0))  # duplicate hit: FP
                else:
                    matched[gi] = True
                    rec.append((float(row[1]), 1))
            else:
                rec.append((float(row[1]), 0))

    def _average_precision(self, rec, prec):
        """VOC 2010+ AP: area under the monotone precision envelope."""
        mrec = np.concatenate([[0.0], rec, [1.0]])
        mpre = np.concatenate([[0.0], prec, [0.0]])
        for i in range(len(mpre) - 2, -1, -1):
            mpre[i] = max(mpre[i], mpre[i + 1])
        idx = np.where(mrec[1:] != mrec[:-1])[0]
        return float(((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]).sum())

    def get(self):
        classes = [c for c, n in self._gt_counts.items() if n > 0]
        if not classes:
            return self.name, float("nan")
        aps = []
        for c in sorted(classes):
            rec = sorted(self._records.get(c, []), key=lambda t: -t[0])
            if not rec:
                aps.append(0.0)
                continue
            tps = np.array([t[1] for t in rec], np.float64)
            tp_cum = np.cumsum(tps)
            fp_cum = np.cumsum(1.0 - tps)
            recall = tp_cum / self._gt_counts[c]
            precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
            aps.append(self._average_precision(recall, precision))
        if self.class_names:
            names = [f"{self.class_names[c]}_AP" if c < len(self.class_names)
                     else f"class{c}_AP" for c in sorted(classes)]
            return ([self.name] + names,
                    [float(np.mean(aps))] + [float(a) for a in aps])
        return self.name, float(np.mean(aps))


@register
class VOC07MApMetric(MApMetric):
    """11-point interpolated AP (reference VOC07MApMetric — the metric the
    reference's published SSD VOC07 numbers use)."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("name", "VOC07_mAP")
        super().__init__(*args, **kwargs)

    def _average_precision(self, rec, prec):
        ap = 0.0
        for t in np.linspace(0.0, 1.0, 11):
            mask = rec >= t
            ap += (float(prec[mask].max()) if mask.any() else 0.0) / 11.0
        return ap


@register
class MCC(EvalMetric):
    """Matthews correlation coefficient for binary classification
    (reference metric.MCC): computed from accumulated confusion
    counts so it composes across batches."""

    def __init__(self, name="mcc", **kwargs):
        super().__init__(name, **kwargs)

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        self._tp = self._tn = self._fp = self._fn = 0

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred, label = _np(pred), _np(label).reshape(-1).astype(np.int64)
            if pred.ndim > 1:
                pred = pred.argmax(axis=-1)
            pred = pred.reshape(-1).astype(np.int64)
            self._tp += int(((pred == 1) & (label == 1)).sum())
            self._tn += int(((pred == 0) & (label == 0)).sum())
            self._fp += int(((pred == 1) & (label == 0)).sum())
            self._fn += int(((pred == 0) & (label == 1)).sum())
            self.num_inst += len(label)

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        tp, tn, fp, fn = self._tp, self._tn, self._fp, self._fn
        denom = np.sqrt(float(tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
        mcc = (tp * tn - fp * fn) / denom if denom > 0 else 0.0
        return self.name, float(mcc)


@register
class NegativeLogLikelihood(EvalMetric):
    """Mean NLL of the labeled class (reference metric.NegativeLogLikelihood)."""

    def __init__(self, eps=1e-12, name="nll-loss", **kwargs):
        super().__init__(name, **kwargs)
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred = _np(pred)
            label = _np(label).astype(np.int64).reshape(-1)
            p = pred.reshape(-1, pred.shape[-1])[np.arange(len(label)), label]
            self.sum_metric += float(-np.log(p + self.eps).sum())
            self.num_inst += len(label)
