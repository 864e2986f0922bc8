"""The kernels' wrappers as dispatcher ops, registered by dispatch key.

``kernel_op`` defines an op of the namespace ``paddle_tpu_torch`` and
registers its bodies with the dispatcher:

- the kernel's wrapper under the ``CUDA`` key and the plain version under
  the ``CPU`` key, so the dispatcher, not Python, picks the body by the
  tensors' device when the op runs.  A traced or exported graph
  (``jit.save``) holds the op itself, not a branch that picked a route,
  and a tensor of another device finds no body and raises;
- a fake body (``register_fake``, also the ``Meta`` body), which gives
  export, the static ``Program`` and selective checkpointing the
  output's shape;
- an ``Autograd`` body: where no input needs a gradient it goes straight
  to the device body below autograd; otherwise one
  ``torch.autograd.Function`` records ``backward``, whose forward calls
  the op below autograd, where a selective-checkpoint policy sees it.

This is ``torch.library.custom_op``'s contract without its generic
Python layers (the device lookup, the flattening of its autograd rule),
which cost the eager paths about as much again as the op's own body on
small calls.
"""

from __future__ import annotations

import torch

NAMESPACE = "paddle_tpu_torch"
LIB = torch.library.Library(NAMESPACE, "FRAGMENT")
_below_autograd = torch._C._AutoDispatchBelowAutograd


def kernel_op(name, schema, *, cuda, cpu, fake, setup_context, backward):
    """Define ``paddle_tpu_torch::<name><schema>`` and return its
    ``OpOverload``.  ``setup_context(ctx, inputs, output)`` and
    ``backward(ctx, *grads)`` are ``register_autograd``'s."""
    LIB.define(name + schema)
    LIB.impl(name, cuda, "CUDA")
    LIB.impl(name, cpu, "CPU")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=LIB)
    op = getattr(getattr(torch.ops, NAMESPACE), name).default

    def forward(ctx, *args):
        with _below_autograd():
            out = op(*args)
        setup_context(ctx, args, out)
        return out

    # the name shows in grad_fn as ``<name>_gradBackward``
    Grad = type(f"{name}_grad", (torch.autograd.Function,),
                {"forward": staticmethod(forward),
                 "backward": staticmethod(backward)})

    def autograd_body(*args):
        if torch.is_grad_enabled() and any(
                isinstance(a, torch.Tensor) and a.requires_grad
                for a in args):
            return Grad.apply(*args)
        with _below_autograd():
            return op(*args)

    LIB.impl(name, autograd_body, "Autograd")
    return op
