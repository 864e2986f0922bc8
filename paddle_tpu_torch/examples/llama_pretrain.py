"""Llama pretraining on one card: the twin of ``examples/llama_pretrain.py``.

    python -m paddle_tpu_torch.examples.llama_pretrain --layers 4 --steps 20
    python -m paddle_tpu_torch.examples.llama_pretrain --device cpu \\
        --hidden 64 --intermediate 128 --layers 2 --heads 4 --kv-heads 2 \\
        --vocab 256 --batch 2 --seq 16 --steps 3

The same flags and defaults as the JAX package's example (the 1.1B
model: hidden 2048, 16 layers, 32/8 heads, vocab 32000; batch 8 x 2048,
bf16 with fp32 master weights, full recompute of every decoder layer,
AdamW with global-norm clip 1.0, ``--accumulate`` for gradient merge),
plus ``--device`` (the CUDA card unless ``cpu`` is asked for).  The data
is ``np.random.default_rng(0)`` tokens and labels, as there.  A mesh
(``--dp``/``--mp``/``--sharding`` above 1, ``--zero``) is ROADMAP.md,
Queue 1, item 14: it raises.  ``--save PREFIX`` writes the reference's
checkpoint pair after the run, ``PREFIX.pdparams`` and ``PREFIX.pdopt``
(``paddle.save``: the reference's file envelope, each package's own
tensor layout).
"""

import argparse
import time

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hidden", type=int, default=2048)
    ap.add_argument("--intermediate", type=int, default=8192)
    ap.add_argument("--layers", type=int, default=16)
    ap.add_argument("--heads", type=int, default=32)
    ap.add_argument("--kv-heads", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=32000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--mp", type=int, default=1)
    ap.add_argument("--sharding", type=int, default=1)
    ap.add_argument("--zero", choices=["os", "os_g", "p_g_os"], default=None)
    ap.add_argument("--accumulate", type=int, default=1)
    ap.add_argument("--bf16", action="store_true", default=True)
    ap.add_argument("--recompute", action="store_true", default=True)
    ap.add_argument("--save", type=str, default=None)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def main(argv=None):
    """Train; returns the losses of steps 0..steps as floats."""
    args = parse_args(argv)
    if args.dp * args.mp * args.sharding > 1 or args.zero:
        raise NotImplementedError(
            "llama_pretrain: --dp/--mp/--sharding/--zero need the mesh and "
            "ZeRO training of ROADMAP.md, Queue 1, item 14 (distributed)")

    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         LlamaPretrainingCriterion)
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    paddle.seed(0)
    cfg = LlamaConfig(
        vocab_size=args.vocab, hidden_size=args.hidden,
        intermediate_size=args.intermediate, num_hidden_layers=args.layers,
        num_attention_heads=args.heads, num_key_value_heads=args.kv_heads,
        max_position_embeddings=args.seq, recompute=args.recompute)
    model = LlamaForCausalLM(cfg, device=args.device,
                             dtype="bfloat16" if args.bf16 else "float32",
                             seed=0)
    model.train()
    criterion = LlamaPretrainingCriterion(cfg)
    opt = AdamW(learning_rate=args.lr, parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0),
                multi_precision=args.bf16)

    def loss_fn(net, tokens, labels):
        return criterion(net(tokens), labels)

    step = TrainStep(model, loss_fn, opt, accumulate_steps=args.accumulate)

    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {n_params / 1e9:.2f}B params | "
          f"mesh dp={args.dp} mp={args.mp} sharding={args.sharding} | "
          f"b{args.batch} s{args.seq} accumulate={args.accumulate} | "
          f"device {step._device}")

    rng = np.random.default_rng(0)
    dev = step._device
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, args.seq)).astype(np.int32)).to(dev)
    labels = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, args.seq)).astype(np.int32)).to(dev)

    losses = [float(step(tokens, labels))]
    print(f"step 0 (compile): loss {losses[0]:.4f}")
    t0 = time.perf_counter()
    for i in range(1, args.steps + 1):
        loss = step(tokens, labels)
        if i % 10 == 0 or i == args.steps:
            losses.append(float(loss))
            dt = time.perf_counter() - t0
            tps = args.batch * args.seq * i / dt
            print(f"step {i}: loss {losses[-1]:.4f} "
                  f"({tps:,.0f} tokens/s)")
        else:
            losses.append(loss)
    if args.save:
        paddle.save(model.state_dict(), args.save + ".pdparams")
        paddle.save(opt.state_dict(), args.save + ".pdopt")
        print(f"saved checkpoint to {args.save}.pdparams/.pdopt")
    return [float(x) for x in losses]


if __name__ == "__main__":
    main()
