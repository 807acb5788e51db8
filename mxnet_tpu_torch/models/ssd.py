"""SSD object detector, config 5 of the baseline set (counterpart of
``mxnet_tpu/models/ssd.py``): anchors by ``MultiBoxPrior``, training
targets by ``MultiBoxTarget`` and :class:`SSDMultiBoxLoss`, inference by
``MultiBoxDetection`` (decode and NMS), all in ``ops/contrib.py``.
``ssd_300`` is the reference's own small backbone (base channels 32/64/
128, three scales of 128 channels), not VGG16.
"""
from __future__ import annotations

import torch

from ..gluon import nn
from ..gluon.block import HybridBlock

__all__ = ["SSD", "SSDMultiBoxLoss", "ssd_300", "hard_negatives"]


def _conv_block(channels, stride=1):
    out = nn.HybridSequential()
    out.add(nn.Conv2D(channels, 3, stride, 1, use_bias=False))
    out.add(nn.BatchNorm())
    out.add(nn.Activation("relu"))
    return out


def _seq(*blocks):
    s = nn.HybridSequential()
    s.add(*blocks)
    return s


class SSD(HybridBlock):
    """Multi-scale single-shot detector.

    forward(x) -> (anchors (1, N, 4), cls_preds (B, N, classes+1),
                   box_preds (B, N*4))
    """

    def __init__(self, num_classes=20, base_channels=(32, 64, 128),
                 scale_channels=(128, 128, 128),
                 sizes=((0.2, 0.272), (0.37, 0.447), (0.54, 0.619)),
                 ratios=((1, 2, 0.5),) * 3, **kwargs):
        super().__init__(**kwargs)
        assert len(scale_channels) == len(sizes) == len(ratios)
        self._num_classes = num_classes
        self._sizes = sizes
        self._ratios = ratios
        self._num_anchors = [len(s) + len(r) - 1
                             for s, r in zip(sizes, ratios)]

        self.base = nn.HybridSequential()
        for c in base_channels:
            self.base.add(_conv_block(c, stride=1))
            self.base.add(nn.MaxPool2D(2, 2))

        self.stages, self.cls_heads, self.box_heads = [], [], []
        for i, c in enumerate(scale_channels):
            stage = _conv_block(c, stride=1) if i == 0 else _seq(
                _conv_block(c), nn.MaxPool2D(2, 2))
            self.register_child(stage, f"stage{i}")
            self.stages.append(stage)
            k = self._num_anchors[i]
            cls = nn.Conv2D(k * (num_classes + 1), 3, padding=1)
            box = nn.Conv2D(k * 4, 3, padding=1)
            self.register_child(cls, f"cls{i}")
            self.register_child(box, f"box{i}")
            self.cls_heads.append(cls)
            self.box_heads.append(box)

    def hybrid_forward(self, F, x):
        x = self.base(x)
        anchors, cls_preds, box_preds = [], [], []
        for i, stage in enumerate(self.stages):
            x = stage(x)
            anchors.append(F.contrib.MultiBoxPrior(x, sizes=self._sizes[i],
                                                   ratios=self._ratios[i]))
            c = self.cls_heads[i](x)  # (B, K*(C+1), H, W)
            b = self.box_heads[i](x)  # (B, K*4, H, W)
            bsz = c.shape[0]
            cls_preds.append(c.transpose((0, 2, 3, 1)).reshape(
                (bsz, -1, self._num_classes + 1)))
            box_preds.append(b.transpose((0, 2, 3, 1)).reshape((bsz, -1)))
        return (F.concat(*anchors, dim=1), F.concat(*cls_preds, dim=1),
                F.concat(*box_preds, dim=1))

    def detect(self, x, nms_threshold=0.45, threshold=0.01, nms_topk=400):
        """Full inference: forward, softmax, decode and NMS -> (B, N, 6)."""
        from .. import ndarray as F

        anchors, cls_preds, box_preds = self(x)
        cls_prob = F.softmax(cls_preds, axis=-1).transpose((0, 2, 1))
        return F.contrib.MultiBoxDetection(cls_prob, box_preds, anchors,
                                           nms_threshold=nms_threshold,
                                           threshold=threshold,
                                           nms_topk=nms_topk)


def hard_negatives(ce, pos, ratio):
    """The hardest negatives of each image: its ``ratio`` x positives
    negatives of largest cross-entropy ``ce`` (B, N), found by a sort; a
    loss equal to the threshold is kept (ties included)."""
    neg_ce = torch.where(pos, torch.full_like(ce, float("-inf")), ce)
    k = torch.clamp((ratio * pos.sum(dim=-1)).to(torch.int32),
                    max=ce.shape[-1] - 1)
    sorted_neg = torch.sort(neg_ce, dim=-1, descending=True).values
    thresh = torch.gather(sorted_neg, -1,
                          torch.clamp(k - 1, min=0).long()[:, None])
    return (neg_ce >= thresh) & (k > 0)[:, None] & ~pos


class SSDMultiBoxLoss:
    """Class cross-entropy over the positives and the hardest negatives
    (``negative_mining_ratio`` x positives per image, chosen by a sort; a
    loss equal to the threshold is kept), plus a smooth-L1 box loss, both
    normalized by the number of positives (GluonCV's SSDMultiBoxLoss)."""

    def __init__(self, negative_mining_ratio=3.0, lambd=1.0):
        self._ratio = negative_mining_ratio
        self._lambd = lambd

    def __call__(self, cls_preds, box_preds, cls_targets, box_targets,
                 box_masks):
        from ..ndarray.ndarray import invoke_fn

        ratio, lambd = self._ratio, self._lambd

        def pure(cp, bp, ct, bt, bm):
            logp = torch.log_softmax(cp, dim=-1)
            ce = -torch.gather(logp, -1,
                               ct.to(torch.int32).long()[..., None])[..., 0]
            pos = ct > 0
            num_pos = torch.clamp(pos.sum(), min=1).to(cp.dtype)
            hard_neg = hard_negatives(ce, pos, ratio)
            cls_loss = torch.where(pos | hard_neg, ce,
                                   torch.zeros_like(ce)).sum() / num_pos
            diff = torch.abs((bp - bt) * bm)
            sl1 = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)
            box_loss = sl1.sum() / num_pos
            return cls_loss + lambd * box_loss

        return invoke_fn(pure, [cls_preds, box_preds, cls_targets,
                                box_targets, box_masks])


def ssd_300(num_classes=20, **kwargs):
    return SSD(num_classes=num_classes, **kwargs)
