"""Loss layers (counterpart of paddle_tpu/nn/layer/loss.py): each calls its
function of ``nn.functional`` with the arguments it was built with."""
from __future__ import annotations

from torch import nn

from .. import functional as PF

__all__ = ["CrossEntropyLoss", "MSELoss", "L1Loss", "NLLLoss", "BCELoss",
           "BCEWithLogitsLoss", "SmoothL1Loss", "KLDivLoss",
           "MarginRankingLoss", "HingeEmbeddingLoss", "CosineEmbeddingLoss",
           "TripletMarginLoss", "CTCLoss"]


class CrossEntropyLoss(nn.Module):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        self.weight, self.ignore_index = weight, ignore_index
        self.reduction, self.soft_label, self.axis = (reduction, soft_label,
                                                      axis)
        self.use_softmax, self.label_smoothing = use_softmax, label_smoothing

    def forward(self, input, label):
        return PF.cross_entropy(
            input, label, weight=self.weight, ignore_index=self.ignore_index,
            reduction=self.reduction, soft_label=self.soft_label,
            axis=self.axis, use_softmax=self.use_softmax,
            label_smoothing=self.label_smoothing)


class _Reduced(nn.Module):
    """A loss whose only setting is ``reduction``."""
    _fn = None

    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return type(self)._fn(input, label, self.reduction)


class MSELoss(_Reduced):
    _fn = staticmethod(PF.mse_loss)


class L1Loss(_Reduced):
    _fn = staticmethod(PF.l1_loss)


class KLDivLoss(_Reduced):
    _fn = staticmethod(PF.kl_div)


class NLLLoss(nn.Module):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__()
        self.weight, self.ignore_index = weight, ignore_index
        self.reduction = reduction

    def forward(self, input, label):
        return PF.nll_loss(input, label, self.weight, self.ignore_index,
                           self.reduction)


class BCELoss(nn.Module):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight, self.reduction = weight, reduction

    def forward(self, input, label):
        return PF.binary_cross_entropy(input, label, self.weight,
                                       self.reduction)


class BCEWithLogitsLoss(nn.Module):
    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__()
        self.weight, self.reduction = weight, reduction
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return PF.binary_cross_entropy_with_logits(
            logit, label, self.weight, self.reduction, self.pos_weight)


class SmoothL1Loss(nn.Module):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self.reduction, self.delta = reduction, delta

    def forward(self, input, label):
        return PF.smooth_l1_loss(input, label, self.reduction, self.delta)


class MarginRankingLoss(nn.Module):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input, other, label):
        return PF.margin_ranking_loss(input, other, label, self.margin,
                                      self.reduction)


class HingeEmbeddingLoss(nn.Module):
    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input, label):
        return PF.hinge_embedding_loss(input, label, self.margin,
                                       self.reduction)


class CosineEmbeddingLoss(nn.Module):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input1, input2, label):
        return PF.cosine_embedding_loss(input1, input2, label, self.margin,
                                        self.reduction)


class TripletMarginLoss(nn.Module):
    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self.args = (margin, p, epsilon, swap, reduction)

    def forward(self, input, positive, negative):
        return PF.triplet_margin_loss(input, positive, negative, *self.args)


class CTCLoss(nn.Module):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank, self.reduction = blank, reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return PF.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                           self.blank, self.reduction, norm_by_times)
