"""Gradient clipping: ``ClipGradByGlobalNorm`` (port of
``paddle_tpu/nn/clip.py:49``).

As in the JAX package's compiled step, the clip is a description held by
the optimizer; ``jit.TrainStep`` applies it: the global norm is the
square root of the sum of fp32 squares of every gradient, and each
gradient is scaled by ``clip_norm / max(norm, clip_norm)``.
``group_name`` and ``auto_skip_clip`` are accepted and ignored, as in the
JAX package.
"""

from __future__ import annotations


class ClipGradByGlobalNorm:
    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
