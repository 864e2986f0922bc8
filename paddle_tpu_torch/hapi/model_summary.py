"""``paddle.summary``: port of ``paddle_tpu/hapi/model_summary.py``.

One row per submodule (``named_modules`` without the root, in the
reference's ``named_sublayers`` order) as its forward hook fires: name,
type, output shape (when an input size or input is given) and its own
parameter count; then the totals.  The table and the totals equal the
reference's for the same network.
"""

from __future__ import annotations

import torch

from ..device import to_dtype

__all__ = ["summary"]


def _device_of(net):
    for t in net.parameters():
        return t.device
    return torch.device("cpu")


def summary(net, input_size=None, dtypes=None, input=None):
    rows = []
    hooks = []

    def make_hook(name):
        def hook(layer, inputs, output):
            out = output[0] if isinstance(output, (tuple, list)) else output
            shape = list(getattr(out, "shape", [])) or ["-"]
            n_params = sum(p.numel() for p in layer.parameters(
                recurse=False))
            rows.append((name, type(layer).__name__, shape, n_params))
        return hook

    if input_size is not None or input is not None:
        for name, sub in net.named_modules():
            if name:
                hooks.append(sub.register_forward_hook(make_hook(name)))
        was_training = net.training
        net.eval()
        try:
            if input is None:
                dtype = to_dtype(dtypes[0] if dtypes else "float32")
                input = torch.zeros(tuple(input_size), dtype=dtype,
                                    device=_device_of(net))
            with torch.no_grad():
                net(input)
        finally:
            for h in hooks:
                h.remove()
            if was_training:
                net.train()

    total = sum(p.numel() for p in net.parameters())
    trainable = sum(p.numel() for p in net.parameters() if p.requires_grad)
    header = f"{'Layer':<32}{'Type':<24}{'Output Shape':<20}{'Params':>10}"
    print(header)
    print("-" * len(header))
    for name, tname, shape, n in rows:
        print(f"{name:<32}{tname:<24}{str(shape):<20}{n:>10}")
    print("-" * len(header))
    print(f"Total params: {total}")
    print(f"Trainable params: {trainable}")
    print(f"Non-trainable params: {total - trainable}")
    return {"total_params": int(total), "trainable_params": int(trainable)}
