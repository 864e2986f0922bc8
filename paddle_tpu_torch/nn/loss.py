"""Loss layers: port of ``paddle_tpu/nn/layer/loss.py``, each the layer
form of its functional (``nn.functional``)."""

from __future__ import annotations

from torch import nn

from . import functional as F

__all__ = ["CrossEntropyLoss", "MSELoss", "L1Loss", "NLLLoss", "BCELoss",
           "BCEWithLogitsLoss", "SmoothL1Loss", "KLDivLoss",
           "MarginRankingLoss", "HingeEmbeddingLoss", "CosineEmbeddingLoss",
           "TripletMarginLoss", "SigmoidFocalLoss", "SoftMarginLoss",
           "MultiLabelSoftMarginLoss", "PoissonNLLLoss", "CTCLoss",
           "RNNTLoss"]


class _Loss(nn.Module):
    """Calls ``F.<_fn>(*inputs, *self._args)``; ``self._args`` are the
    functional's options in its positional order after the inputs."""

    _fn = None

    def __init__(self, *args):
        super().__init__()
        self._args = args

    def forward(self, *inputs):
        return getattr(F, self._fn)(*inputs, *self._args)


class CrossEntropyLoss(_Loss):
    _fn = "cross_entropy"

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__(weight, ignore_index, reduction, soft_label, axis,
                         use_softmax, label_smoothing)


class MSELoss(_Loss):
    _fn = "mse_loss"

    def __init__(self, reduction="mean"):
        super().__init__(reduction)


class L1Loss(_Loss):
    _fn = "l1_loss"

    def __init__(self, reduction="mean", name=None):
        super().__init__(reduction)


class NLLLoss(_Loss):
    _fn = "nll_loss"

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__(weight, ignore_index, reduction)


class BCELoss(_Loss):
    _fn = "binary_cross_entropy"

    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__(weight, reduction)


class BCEWithLogitsLoss(_Loss):
    _fn = "binary_cross_entropy_with_logits"

    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__(weight, reduction, pos_weight)


class SmoothL1Loss(_Loss):
    _fn = "smooth_l1_loss"

    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__(reduction, delta)


class KLDivLoss(_Loss):
    _fn = "kl_div"

    def __init__(self, reduction="mean", log_target=False):
        super().__init__(reduction, log_target)


class MarginRankingLoss(_Loss):
    _fn = "margin_ranking_loss"

    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__(margin, reduction)


class HingeEmbeddingLoss(_Loss):
    _fn = "hinge_embedding_loss"

    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__(margin, reduction)


class CosineEmbeddingLoss(_Loss):
    _fn = "cosine_embedding_loss"

    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__(margin, reduction)


class TripletMarginLoss(_Loss):
    _fn = "triplet_margin_loss"

    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean", name=None):
        super().__init__(margin, p, epsilon, swap, reduction)


class SigmoidFocalLoss(_Loss):
    _fn = "sigmoid_focal_loss"

    def __init__(self, alpha=0.25, gamma=2.0, normalizer=None,
                 reduction="sum", name=None):
        super().__init__(normalizer, alpha, gamma, reduction)


class SoftMarginLoss(_Loss):
    _fn = "soft_margin_loss"

    def __init__(self, reduction="mean", name=None):
        super().__init__(reduction)


class MultiLabelSoftMarginLoss(_Loss):
    _fn = "multi_label_soft_margin_loss"

    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__(weight, reduction)


class PoissonNLLLoss(_Loss):
    _fn = "poisson_nll_loss"

    def __init__(self, log_input=True, full=False, epsilon=1e-8,
                 reduction="mean", name=None):
        super().__init__(log_input, full, epsilon, reduction)


class RNNTLoss(nn.Module):
    def __init__(self, blank=0, fastemit_lambda=0.001, reduction="mean",
                 name=None):
        super().__init__()
        self.blank, self.fastemit_lambda = blank, fastemit_lambda
        self.reduction = reduction

    def forward(self, input, label, input_lengths, label_lengths):
        return F.rnnt_loss(input, label, input_lengths, label_lengths,
                           blank=self.blank,
                           fastemit_lambda=self.fastemit_lambda,
                           reduction=self.reduction)


class CTCLoss(nn.Module):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank, self.reduction = blank, reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          self.blank, self.reduction, norm_by_times)
