"""Quantization rules of the port (the serving loader's absmax rule)."""

from .observers import (PerChannelAbsmaxObserver,  # noqa: F401
                        absmax_to_scales, quantize_channelwise)
