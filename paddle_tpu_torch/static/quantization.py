"""Static-graph quantization namespace: a copy of
``paddle_tpu/static/quantization.py``.  Static quantization is the
quantization package applied to the model; the reference's class names
are aliases, and ``quant_post_static`` calibrates and converts."""

from __future__ import annotations

from ..quantization import PTQ, QAT, QuantConfig  # noqa: F401
from ..quantization.observers import (AbsmaxObserver,  # noqa: F401
                                      MovingAverageAbsmaxObserver,
                                      PerChannelAbsmaxObserver)

__all__ = ["PTQ", "QAT", "QuantConfig", "quant_post_static",
           "AbsmaxObserver", "MovingAverageAbsmaxObserver",
           "PerChannelAbsmaxObserver"]


def quant_post_static(model, calibration_loader, batch_nums=10,
                      activation_observer=None, weight_bits=8):
    """Post-training static quantization (the reference's
    ``quant_post_static``): calibrate a copy of ``model`` on
    ``batch_nums`` batches and return it converted to int8; the caller's
    float model stays untouched."""
    from ..quantization.config import quanter_factory

    obs = activation_observer or AbsmaxObserver
    ptq = PTQ(QuantConfig(
        activation=obs,
        weight=quanter_factory(PerChannelAbsmaxObserver,
                               bit_length=weight_bits)))
    qmodel = ptq.quantize(model, inplace=False)
    for i, batch in enumerate(calibration_loader):
        if i >= batch_nums:
            break
        x = batch[0] if isinstance(batch, (tuple, list)) else batch
        qmodel(x)
    return ptq.convert(qmodel)
