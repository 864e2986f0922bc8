"""Training callbacks: a copy of ``paddle_tpu/hapi/callbacks.py``.

``ProgBarLogger`` logs samples/s and the ETA; ``ModelCheckpoint`` saves
through ``Model.save``; ``LRScheduler`` steps the port's
``optimizer.lr`` schedulers.  ``EarlyStopping`` acts in
``on_eval_end``, which neither ``fit`` nor ``evaluate`` calls, in the
reference as here, so it never stops a run (ROADMAP.md, "Reference
findings, not port faults").
"""

from __future__ import annotations

import time

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "EarlyStopping",
           "LRScheduler", "config_callbacks"]


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params or {}

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = list(callbacks)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def call(*args, **kwargs):
                for c in self.callbacks:
                    getattr(c, name)(*args, **kwargs)
            return call
        raise AttributeError(name)


class ProgBarLogger(Callback):
    """Training progress (reference hapi ProgBarLogger): verbose=1 is an
    in-place progress bar with ETA and samples/s; verbose=2 prints a
    line every ``log_freq`` steps with throughput."""

    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def _fmt(self, logs):
        return ", ".join(f"{k}: {v:.4f}" if isinstance(v, float)
                         else f"{k}: {v}"
                         for k, v in (logs or {}).items())

    def _rate_eta(self):
        dur = max(time.time() - self._start, 1e-9)
        ips = None
        bs = self.params.get("batch_size")
        if bs:
            ips = self.steps * bs / dur
        total = self.params.get("steps")
        eta = None
        if total:
            eta = dur / max(self.steps, 1) * (total - self.steps)
        return ips, eta

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = 0
        self._start = time.time()

    def on_train_batch_end(self, step, logs=None):
        self.steps += 1
        if not self.verbose:
            return
        ips, eta = self._rate_eta()
        extra = ""
        if ips is not None:
            extra += f", {ips:.1f} samples/s"
        if eta is not None:
            extra += f", ETA {eta:.0f}s"
        if self.verbose == 1:
            total = self.params.get("steps")
            frac = f"{self.steps}/{total}" if total else f"{self.steps}"
            print(f"\repoch {self.epoch} [{frac}] "
                  f"{self._fmt(logs)}{extra}   ", end="", flush=True)
        elif self.steps % self.log_freq == 0:
            print(f"epoch {self.epoch} step {step}: "
                  f"{self._fmt(logs)}{extra}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose == 1:
            print()
        if self.verbose:
            dur = time.time() - self._start
            print(f"epoch {epoch} done in {dur:.1f}s: {self._fmt(logs)}")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and epoch % self.save_freq == 0:
            self.model.save(f"{self.save_dir}/{epoch}")

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(f"{self.save_dir}/final")


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = min_delta
        self.best = None
        self.wait = 0
        self.stopped = False
        if mode == "auto":
            mode = "min" if "loss" in monitor or "err" in monitor else "max"
        self.mode = mode

    def on_eval_end(self, logs=None):
        logs = logs or {}
        value = logs.get(self.monitor)
        if value is None:
            return
        if isinstance(value, (list, tuple)):
            value = value[0]
        better = (self.best is None or
                  (value < self.best - self.min_delta if self.mode == "min"
                   else value > self.best + self.min_delta))
        if better:
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped = True
                self.model.stop_training = True


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        from ..optimizer.lr import LRScheduler as Sched
        opt = getattr(self.model, "_optimizer", None)
        if opt is not None and isinstance(opt._learning_rate, Sched):
            return opt._learning_rate
        return None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if s is not None and self.by_step:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if s is not None and self.by_epoch:
            s.step()


def config_callbacks(callbacks=None, model=None, batch_size=None, epochs=None,
                     steps=None, log_freq=2, verbose=2, save_freq=1,
                     save_dir=None, metrics=None, mode="train"):
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks.append(ProgBarLogger(log_freq, verbose))
    if save_dir and not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks.append(ModelCheckpoint(save_freq, save_dir))
    cl = CallbackList(cbks)
    cl.set_model(model)
    cl.set_params({"batch_size": batch_size, "epochs": epochs, "steps": steps,
                   "verbose": verbose, "metrics": metrics or []})
    return cl
