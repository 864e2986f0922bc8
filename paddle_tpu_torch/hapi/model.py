"""``paddle.Model``: port of ``paddle_tpu/hapi/model.py``.

``fit``/``evaluate``/``predict`` are the reference's loops.  Batches go
to the network's device: ``fit`` builds its ``DataLoader`` there, and
every ``*_batch`` moves its inputs there.

- ``prepare(jit=True)`` (the default) trains through the port's
  ``jit.TrainStep`` when the optimizer is one the compiled step takes
  (SGD, Momentum, Adam and AdamW: the reference's test,
  ``step._update_fn is None``, decided on the optimizer's type by
  ``jit.train_step.select_update``, the step's own predicate); any
  other optimizer trains eagerly (``loss.backward()``, ``step()``).
  The forward's outputs come back from the step as aux, for the
  train-batch metrics.
- AMP: O1 runs the forward and the loss under ``amp.auto_cast``; O1
  with ``jit=False`` adds a ``GradScaler``.  O2 casts the network to
  bf16 (``.to(torch.bfloat16)``) and turns on the optimizer's
  ``_multi_precision``; batches are not cast, so a float32 batch into a
  bf16 convolution raises ``TypeError``, as in the reference.
- ``save(path)`` writes ``path.pdparams`` and ``path.pdopt`` through
  ``framework.io.save``; ``load`` restores both in place.
  ``save(training=False)`` exports an inference program through
  ``jit.save``, which is ROADMAP.md, Queue 1, item 13 (framework
  surface: jit and static): it raises, after the reference's
  ``ValueError`` when no input specs were given.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from ..device import resolve_device
from ..io import DataLoader
from ..metric import Metric
from .callbacks import config_callbacks

__all__ = ["Model"]


def _loss_value(loss) -> float:
    """The host's read of a step's loss (one device-to-host copy)."""
    return float(loss.detach())


def _to_device(x, device):
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    if isinstance(x, torch.Tensor) and x.device != device:
        return x.to(device, non_blocking=True)
    return x


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs if isinstance(inputs, (list, tuple)) else (
            [inputs] if inputs is not None else None)
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self.stop_training = False
        self._train_step = None
        self._amp_level = None
        self._scaler = None

    def _device(self) -> torch.device:
        """The device of the network's tensors; a network without any
        runs on the card (raising without CUDA)."""
        for t in self.network.parameters():
            return t.device
        for t in self.network.buffers():
            return t.device
        return resolve_device(None)

    # ---- configuration ----
    def prepare(self, optimizer=None, loss=None, metrics=None, jit=True,
                amp_configs=None):
        """``amp_configs``: "O1"/"O2" or a dict with "level"."""
        self._optimizer = optimizer
        self._loss = loss
        if metrics is not None:
            self._metrics = metrics if isinstance(metrics, list) else [metrics]
        self._use_jit = jit
        if amp_configs is not None:
            if isinstance(amp_configs, str):
                self._amp_level = amp_configs
            else:
                self._amp_level = amp_configs.get("level", "O1")
            if self._amp_level not in ("O0", "O1", "O2"):
                raise ValueError(
                    f"amp level must be O0/O1/O2, got {self._amp_level!r}")
            if self._amp_level == "O2":
                self.network.to(torch.bfloat16)
                if optimizer is not None:
                    optimizer._multi_precision = True
            if self._amp_level in ("O1",) and not jit:
                from ..amp import GradScaler
                self._scaler = GradScaler()
        return self

    def _fleet_world(self):
        """Data-parallel process world when a launcher is active."""
        from ..distributed import get_world_size
        return get_world_size()

    def _make_loader(self, data, batch_size, shuffle, num_workers=0):
        if data is None or isinstance(data, DataLoader):
            return data
        places = self._device()
        if self._fleet_world() > 1:
            # each process reads its shard, as the reference's
            # distributed fit does
            from ..io import DistributedBatchSampler
            sampler = DistributedBatchSampler(
                data, batch_size=batch_size, shuffle=shuffle)
            return DataLoader(data, batch_sampler=sampler,
                              num_workers=num_workers, places=places)
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                          num_workers=num_workers, places=places)

    def _compute_loss(self, outputs, labels):
        outs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
        lbls = labels if isinstance(labels, (list, tuple)) else [labels]
        if self._loss is None:
            return outs[0]
        return self._loss(*outs, *lbls)

    def _split_batch(self, batch):
        if isinstance(batch, (list, tuple)) and len(batch) >= 2:
            return batch[:-1], batch[-1:]
        return (batch,), ()

    def _update_train_metrics(self, outputs, labels):
        """Metrics on the train batch (the reference computes them there
        too); returns the accumulated values ([] without metrics)."""
        if not self._metrics:
            return []
        outs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
        vals = []
        for m in self._metrics:
            res = m.compute(*outs, *labels)
            m.update(res)
            vals.append(m.accumulate())
        return vals

    def _batch_args(self, inputs, labels=None):
        dev = self._device()
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        labels = labels if isinstance(labels, (list, tuple)) else (
            [labels] if labels is not None else [])
        return ([_to_device(x, dev) for x in inputs],
                [_to_device(y, dev) for y in labels])

    # ---- steps ----
    def train_batch(self, inputs, labels=None, update=True):
        """Returns ``[loss]``, or ``([loss], metric_values)`` when
        metrics were configured in ``prepare``."""
        self.network.train()
        inputs, labels = self._batch_args(inputs, labels)
        if self._use_jit and self._train_step is None:
            from ..jit.train_step import TrainStep, select_update
            if select_update(self._optimizer) is not None:
                self._train_step = TrainStep(
                    self.network, self._step_loss_fn(len(inputs)),
                    self._optimizer)
            else:
                self._train_step = False   # the eager path
        if self._train_step:
            out = self._train_step(*inputs, *labels)
            if isinstance(out, tuple):
                loss, outs = out[0], list(out[1:])
                metrics = self._update_train_metrics(outs, labels)
                return [_loss_value(loss)], metrics
            return [_loss_value(out)]
        if self._amp_level == "O1":
            from .. import amp as _amp
            with _amp.auto_cast(level="O1"):
                outputs = self.network(*inputs)
                loss = self._compute_loss(outputs, labels)
            if self._scaler is not None:
                scaled = self._scaler.scale(loss)
                scaled.backward()
                if update:
                    self._scaler.step(self._optimizer)
                    self._scaler.update()
                    self._optimizer.clear_grad()
                return self._train_result(loss, outputs, labels)
        else:
            outputs = self.network(*inputs)
            loss = self._compute_loss(outputs, labels)
        loss.backward()
        if update:
            self._optimizer.step()
            self._optimizer.clear_grad()
        return self._train_result(loss, outputs, labels)

    def _step_loss_fn(self, n_in):
        """The ``TrainStep`` loss: the forward and the loss (under
        ``auto_cast`` at O1), with the outputs as aux when metrics
        read them."""
        amp_level = self._amp_level
        want_outputs = bool(self._metrics)

        def loss_fn(net, *args):
            def run():
                outs = net(*args[:n_in])
                loss = self._compute_loss(outs, list(args[n_in:]))
                if want_outputs:
                    outs_t = outs if isinstance(outs, (list, tuple)) \
                        else [outs]
                    return (loss,) + tuple(outs_t)
                return loss

            if amp_level == "O1":
                from .. import amp as _amp
                with _amp.auto_cast(level="O1"):
                    return run()
            return run()

        return loss_fn

    def _train_result(self, loss, outputs, labels):
        losses = [_loss_value(loss)]
        if self._metrics:
            outputs = [o.detach() for o in outputs] \
                if isinstance(outputs, (list, tuple)) else outputs.detach()
            return losses, self._update_train_metrics(outputs, labels)
        return losses

    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        inputs, labels = self._batch_args(inputs, labels)
        with torch.no_grad():
            outputs = self.network(*inputs)
            loss = self._compute_loss(outputs, labels)
            metrics = []
            for m in self._metrics:
                outs = outputs if isinstance(outputs, (list, tuple)) \
                    else [outputs]
                res = m.compute(*outs, *labels)
                m.update(res)
                metrics.append(m.accumulate())
        return [_loss_value(loss)], metrics

    def predict_batch(self, inputs):
        self.network.eval()
        inputs, _ = self._batch_args(inputs)
        with torch.no_grad():
            outputs = self.network(*inputs)
        return outputs

    # ---- loops ----
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        loader = self._make_loader(train_data, batch_size, shuffle,
                                   num_workers)
        eval_loader = self._make_loader(eval_data, batch_size, False)
        try:
            n_steps = len(loader)
        except TypeError:
            n_steps = None
        # a user-supplied DataLoader carries its own batch size; fit's
        # batch_size argument only applies to a loader built here
        eff_bs = batch_size
        if isinstance(train_data, DataLoader):
            eff_bs = getattr(train_data, "batch_size", None)
        cbks = config_callbacks(callbacks, model=self, epochs=epochs,
                                batch_size=eff_bs, steps=n_steps,
                                log_freq=log_freq, verbose=verbose,
                                save_dir=save_dir, save_freq=save_freq,
                                metrics=[n for m in self._metrics
                                         for n in (m.name() if isinstance(
                                             m.name(), list) else [m.name()])])
        self.stop_training = False
        cbks.on_train_begin()
        iters = 0
        logs = None
        for epoch in range(epochs):
            cbks.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            logs = {}
            for step, batch in enumerate(loader):
                cbks.on_train_batch_begin(step)
                ins, lbls = self._split_batch(batch)
                out = self.train_batch(list(ins), list(lbls))
                if isinstance(out, tuple):
                    losses, mvals = out
                else:
                    losses, mvals = out, []
                logs = {"loss": losses[0]}
                for m, v in zip(self._metrics, mvals):
                    names = m.name() if isinstance(m.name(), list) \
                        else [m.name()]
                    vals = v if isinstance(v, (list, tuple)) else [v]
                    for n, val in zip(names, vals):
                        logs[n] = val
                cbks.on_train_batch_end(step, logs)
                iters += 1
                if num_iters is not None and iters >= num_iters:
                    self.stop_training = True
                    break
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self.evaluate(eval_loader, verbose=0)
                logs.update({f"eval_{k}": v for k, v in eval_logs.items()})
            cbks.on_epoch_end(epoch, logs)
            if self.stop_training:
                break
        cbks.on_train_end(logs)
        return self

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_iters=None):
        loader = self._make_loader(eval_data, batch_size, False)
        for m in self._metrics:
            m.reset()
        losses = []
        for step, batch in enumerate(loader):
            ins, lbls = self._split_batch(batch)
            l, _ = self.eval_batch(list(ins), list(lbls))
            losses.append(l[0])
            if num_iters is not None and step + 1 >= num_iters:
                break
        logs = {"loss": float(np.mean(losses)) if losses else 0.0}
        for m in self._metrics:
            names = m.name() if isinstance(m.name(), list) else [m.name()]
            vals = m.accumulate()
            vals = vals if isinstance(vals, (list, tuple)) else [vals]
            for n, v in zip(names, vals):
                logs[n] = v
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        loader = self._make_loader(test_data, batch_size, False)
        outputs = []
        for batch in loader:
            ins = batch if isinstance(batch, (list, tuple)) else [batch]
            outs = self.predict_batch(list(ins))
            outputs.append(outs)
        return outputs

    # ---- persistence / info ----
    def save(self, path, training=True):
        """training=True: a checkpoint (``path.pdparams`` and, with an
        optimizer, ``path.pdopt``).  training=False: the inference
        export, which waits on the port's ``jit.save``."""
        if not training:
            if self._inputs is None:
                raise ValueError(
                    "Model.save(training=False) exports an inference "
                    "model and needs input specs: Model(net, "
                    "inputs=[InputSpec(...)])")
            raise NotImplementedError(
                "Model.save(training=False) exports through jit.save, "
                "ROADMAP.md, Queue 1, item 13 (framework surface: jit and "
                "static)")
        from ..framework.io import save as fsave
        fsave(self.network.state_dict(), path + ".pdparams")
        if self._optimizer is not None:
            fsave(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from ..framework.io import load as fload
        self.network.load_state_dict(fload(path + ".pdparams"))
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(path + ".pdopt"):
            self._optimizer.set_state_dict(fload(path + ".pdopt"))

    def parameters(self, *args, **kwargs):
        return self.network.parameters()

    def summary(self, input_size=None, dtype=None):
        from .model_summary import summary as _summary
        return _summary(self.network, input_size=input_size,
                        dtypes=[dtype] if dtype else None)
