"""ResNet on CIFAR-10 through the hapi ``Model`` API on one card: the twin
of ``examples/resnet_cifar.py`` (BASELINE.md config 1).

    python -m paddle_tpu_torch.examples.resnet_cifar --epochs 1
    python -m paddle_tpu_torch.examples.resnet_cifar --device cpu \\
        --epochs 1 --batch-size 8
    python -m paddle_tpu_torch.examples.resnet_cifar \\
        --data-file /path/cifar-10-python.tar.gz

The same flags and defaults as the JAX package's example (ResNet-18,
2 epochs, batch 64, Adam at 1e-3, ``--amp O1/O2``, ``--num-workers``),
plus ``--device`` (the CUDA card unless ``cpu`` is asked for).  Without
``--data-file`` the data is ``Cifar10``'s synthetic images (1024 train,
256 test).  ``--export PREFIX`` writes the inference artifact after the
evaluation (``Model.save(training=False)``, through ``jit.save``:
``PREFIX.ptpu_torch_model`` and ``PREFIX.ptpu_params``), which
``inference.create_predictor`` serves.  Its batch dimension is dynamic
(``InputSpec((None, 3, 32, 32))``), so the artifact serves any batch; the
reference's spec, ``(1, 3, 32, 32)``, exports batch 1 only.  ``main``
returns the final ``evaluate`` logs.
"""

import argparse


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-file", type=str, default=None)
    ap.add_argument("--arch", type=str, default="resnet18")
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--amp", type=str, default=None,
                    choices=[None, "O1", "O2"])
    ap.add_argument("--num-workers", type=int, default=0)
    ap.add_argument("--export", type=str, default=None,
                    help="prefix to export the inference artifact")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def main(argv=None):
    """Train and evaluate; returns the final ``evaluate`` logs."""
    args = parse_args(argv)

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.static import InputSpec
    from paddle_tpu_torch.vision import models as vmodels
    from paddle_tpu_torch.vision.datasets import Cifar10

    paddle.seed(0)
    train = Cifar10(data_file=args.data_file, mode="train")
    test = Cifar10(data_file=args.data_file, mode="test")

    net = getattr(vmodels, args.arch)(num_classes=10, device=args.device)
    model = paddle.Model(net,
                         inputs=[InputSpec((None, 3, 32, 32), "float32")])
    model.prepare(
        optimizer=paddle.optimizer.Adam(learning_rate=args.lr,
                                        parameters=net.parameters()),
        loss=nn.CrossEntropyLoss(),
        metrics=paddle.metric.Accuracy(),
        amp_configs=args.amp)
    model.fit(train, eval_data=test, epochs=args.epochs,
              batch_size=args.batch_size, num_workers=args.num_workers,
              verbose=2)
    logs = model.evaluate(test, batch_size=args.batch_size, verbose=0)
    print(logs)
    if args.export:
        model.save(args.export, training=False)
        print(f"inference artifact exported to "
              f"{args.export}.ptpu_torch_model")
    return logs


if __name__ == "__main__":
    main()
