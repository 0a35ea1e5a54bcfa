"""hapi callbacks (counterpart of paddle_tpu/hapi/callbacks.py): hooks that
``Model.fit`` calls at the edges of training, epochs, batches and
evaluation."""
from __future__ import annotations

import time

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "EarlyStopping",
           "LRScheduler", "CallbackList"]


class Callback:
    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

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

    def __getattr__(self, name):
        def call(*args, **kwargs):
            for cb in self.callbacks:
                getattr(cb, name)(*args, **kwargs)

        return call


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = 0
        self._t0 = time.time()

    def on_train_batch_end(self, step, logs=None):
        self.steps += 1
        if self.verbose and step % self.log_freq == 0:
            items = " - ".join(f"{k}: {v:.4f}" if isinstance(v, float)
                               else f"{k}: {v}"
                               for k, v in (logs or {}).items())
            print(f"Epoch {self.epoch} step {step}: {items}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._t0
            print(f"Epoch {epoch} done in {dt:.1f}s")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and epoch % self.save_freq == 0:
            self.model.save(f"{self.save_dir}/{epoch}")

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(f"{self.save_dir}/final")


class EarlyStopping(Callback):
    """Stop ``fit`` when ``monitor`` has not improved for more than
    ``patience`` checks. Improvement is checked on the evaluation's logs
    when evaluation runs, else on the epoch's training logs.
    ``save_best_model`` keeps copies of the weights at the best check and
    restores them when stopping."""

    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        self.mode = "min" if mode in ("auto", "min") else "max"
        if mode == "auto" and not ("loss" in monitor or "err" in monitor):
            self.mode = "max"

    def on_train_begin(self, logs=None):
        self.wait = 0
        self.stopped = False
        self.stopped_epoch = 0
        self.best_weights = None
        self._saw_eval = False
        self.best = self.baseline if self.baseline is not None else (
            float("inf") if self.mode == "min" else -float("inf"))

    def on_eval_begin(self, logs=None):
        self._saw_eval = True

    def on_eval_end(self, logs=None):
        self._check(logs)

    def on_epoch_end(self, epoch, logs=None):
        self._epoch = epoch
        # avoid double-counting: when eval runs, only eval logs are checked
        if not self._saw_eval:
            self._check(logs)

    def _snapshot(self):
        return {k: v.detach().clone()
                for k, v in self.model.network.state_dict().items()}

    def _check(self, logs):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        cur = float(cur[0] if isinstance(cur, (list, tuple)) else cur)
        improved = (cur < self.best - self.min_delta if self.mode == "min"
                    else cur > self.best + self.min_delta)
        if improved:
            self.best = cur
            self.wait = 0
            if self.save_best_model and getattr(self, "model", None):
                self.best_weights = self._snapshot()
        else:
            self.wait += 1
            if self.wait > self.patience:
                self.stopped = True
                self.stopped_epoch = getattr(self, "_epoch", 0)
                self.model.stop_training = True
                if self.best_weights is not None:
                    # copied in place: a captured training step stays valid
                    self.model.network.load_state_dict(self.best_weights)
                if self.verbose:
                    print(f"Early stopping: {self.monitor} did not improve "
                          f"for {self.wait} checks (best {self.best:.6g})")


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        from ..optimizer.lr import LRScheduler as Sched

        if opt and isinstance(opt._learning_rate, Sched):
            return opt._learning_rate
        return None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if s and self.by_step:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if s and self.by_epoch:
            s.step()


class VisualDL(Callback):
    """Training and evaluation scalars, appended to
    ``<log_dir>/scalars.jsonl`` as ``{"tag", "value", "step"}`` lines (the
    reference's file; there is no VisualDL writer)."""

    def __init__(self, log_dir="./vdl_log"):
        self.log_dir = log_dir
        self._step = 0

    def _write(self, tag, value, step):
        import json
        import os

        os.makedirs(self.log_dir, exist_ok=True)
        with open(os.path.join(self.log_dir, "scalars.jsonl"), "a") as f:
            f.write(json.dumps({"tag": tag, "value": float(value),
                                "step": int(step)}) + "\n")

    def _write_logs(self, prefix, logs):
        for k, v in (logs or {}).items():
            try:
                self._write(f"{prefix}/{k}",
                            v[0] if isinstance(v, (list, tuple)) else v,
                            self._step)
            except (TypeError, ValueError):
                pass

    def on_train_batch_end(self, step, logs=None):
        self._step += 1
        self._write_logs("train", logs)

    def on_eval_end(self, logs=None):
        self._write_logs("eval", logs)


class ReduceLROnPlateau(Callback):
    """Scale the optimizer's rate by ``factor`` (not below ``min_lr``)
    after ``patience`` epochs without improvement of ``monitor``;
    ``cooldown`` epochs after a reduction do not count."""

    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0.0):
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = min_delta
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.mode = "min" if mode in ("auto", "min") else "max"
        if mode == "auto" and not ("loss" in monitor or "err" in monitor):
            self.mode = "max"

    def on_train_begin(self, logs=None):
        self.wait = 0
        self.cooldown_counter = 0
        self.best = float("inf") if self.mode == "min" else -float("inf")

    def on_epoch_end(self, epoch, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        cur = float(cur[0] if isinstance(cur, (list, tuple)) else cur)
        improved = (cur < self.best - self.min_delta if self.mode == "min"
                    else cur > self.best + self.min_delta)
        if improved:
            self.best = cur
            self.wait = 0
        elif self.cooldown_counter > 0:
            # in cooldown: epochs don't count against patience
            self.cooldown_counter -= 1
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                opt = getattr(self.model, "_optimizer", None)
                if opt is None:
                    return
                old = float(opt.get_lr())
                new = max(old * self.factor, self.min_lr)
                if old - new > 1e-12:
                    opt.set_lr(new)
                    if self.verbose:
                        print(f"ReduceLROnPlateau: lr {old:.3g} -> "
                              f"{new:.3g}")
                self.cooldown_counter = self.cooldown
                self.wait = 0
