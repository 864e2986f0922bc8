"""Fused transformer layers: port of ``paddle_tpu/incubate/nn/layer.py``.

``FusedMultiHeadAttention`` is the port's ``nn.MultiHeadAttention`` (the
same math, as in the reference); ``FusedFeedForward`` is ``linear2(
dropout(act(linear1(x))))`` with ReLU or GELU.  Both take the port's
``device=`` (the card unless ``"cpu"``) and ``dtype=`` keywords.
"""

from __future__ import annotations

from ...nn import functional as F
from ...nn.common import Linear
from ...nn.layers import Layer
from ...nn.transformer import MultiHeadAttention

__all__ = ["FusedMultiHeadAttention", "FusedFeedForward"]


class FusedMultiHeadAttention(MultiHeadAttention):
    """Fused QKV attention: the same math as ``nn.MultiHeadAttention``."""


class FusedFeedForward(Layer):
    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 activation="relu", *, device=None, dtype="float32",
                 **kwargs):
        super().__init__()
        self.linear1 = Linear(d_model, dim_feedforward, device=device,
                              dtype=dtype)
        self.linear2 = Linear(dim_feedforward, d_model, device=device,
                              dtype=dtype)
        self.dropout_rate = dropout_rate
        self.activation = activation

    def forward(self, x):
        act = {"relu": F.relu, "gelu": F.gelu}[self.activation]
        h = act(self.linear1(x))
        h = F.dropout(h, self.dropout_rate, training=self.training)
        return self.linear2(h)
