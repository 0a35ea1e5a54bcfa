"""``Model``: prepare, fit, evaluate, predict, save and load (counterpart of
paddle_tpu/hapi/model.py).

``train_batch`` runs one ``jit.TrainStep``: on the card the step is one
CUDA graph replay after its first two calls (eager, then capture), with
the forward under ``amp.auto_cast`` when ``prepare`` was given
``amp_configs``. ``fit`` feeds it from a ``DataLoader`` and adds the
reference's fault tolerance: rolling epoch checkpoints in ``save_dir``
(``{epoch}.pdparams`` / ``.pdopt`` in the reference's layout, then a
``.pdmeta`` commit marker with their crc32s and sizes and the RNG states),
``resume=True`` from the newest checkpoint that verifies, and an emergency
checkpoint at the next batch boundary after SIGTERM. A ``save_dir``
written by the reference's ``fit`` resumes here and the other way round.

With ``fleet.init`` run over more than one process, ``train_batch`` is
the counterpart of the reference's SPMD branch: the network is sharded
in place once, as ``fleet.distributed_model`` does under ``use_spmd``
(sliced over the mp group, its gradients averaged over the ranks that
split the batch, dp x sharding x ep), whatever form ``distributed_model``
would pick for a loop of the user's own; each batch goes through
``spmd.shard_batch`` (this rank's rows), and the loss returned is the
mean over those ranks, the global batch's, as the reference reports it.
Build the optimizer before the first batch and keep the same order of
batches on every rank.

``fit(elastic=ctx)`` takes a ``distributed.fleet.elastic.
ElasticTrainContext``: a global step with a boundary tick after each
batch, a peer's preemption taken as this rank's, a failed fence check
ending training with nothing saved, and the emergency checkpoint written
only while the fence holds.

On a mesh with ``pp > 1`` ``train_batch`` is the reference's pipeline
branch: it builds a ``distributed.pp_spmd.PipelineSpmdStep`` over the
network, the optimizer and the loss (exactly one input and one label;
``amp_configs`` refused, with the reference's messages), whose loss is
already the global batch's. ``eval_batch`` / ``predict_batch`` first make
the network whole (``sync_params_to_model``); ``save`` writes the whole
model and the optimizer's canonical per-layer state
(``export_optimizer_state``), and ``load`` retires the step (``release``)
so the next ``train_batch`` builds a new one from the loaded state.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import signal
import threading
import zlib

import numpy as np
import torch

from .. import convert, framework
from ..amp import auto_cast
from ..distributed import collective, fleet, spmd
from ..incubate.checkpoint import _rng_restore, _rng_snapshot
from ..io import DataLoader
from ..jit import TrainStep
from ..profiler import RecordEvent
from ..profiler import explainer as _explain
from ..testing import faults as _faults

__all__ = ["Model"]

_END = object()  # the fit loop's end-of-epoch marker (a batch may be None)

_EPOCH_CKPT_RE = re.compile(r"^(\d+)\.pdparams$")


def _epoch_ckpts(save_dir):
    """Epochs with a params file under ``save_dir``, ascending."""
    try:
        names = os.listdir(save_dir)
    except OSError:
        return []
    return sorted(int(m.group(1)) for n in names
                  if (m := _EPOCH_CKPT_RE.match(n)))


def _np_rng_snapshot():
    name, keys, pos, has_gauss, cached = np.random.get_state()
    return [name, keys.tolist(), int(pos), int(has_gauss), float(cached)]


def _write_epoch_meta(prefix, epoch, network, emergency=False):
    """The ``.pdmeta`` commit marker of one epoch checkpoint, written
    atomically after its params and optimizer files: the epoch, each
    file's crc32 and size, and the RNG states (torch's generators as
    ``torch_rng``, the model's dropout generator with them; numpy's global
    generator, which the samplers draw from, as ``np_rng``). ``rng`` is the
    reference's threefry key, which the port has none of."""
    files = {}
    for suffix in (".pdparams", ".pdopt"):
        try:
            with open(prefix + suffix, "rb") as f:
                blob = f.read()
        except OSError:
            continue
        files[suffix] = {"crc32": zlib.crc32(blob), "bytes": len(blob)}
    framework.atomic_write_bytes(json.dumps(
        {"schema": 1, "epoch": int(epoch), "rng": None,
         "torch_rng": _rng_snapshot(network), "np_rng": _np_rng_snapshot(),
         "emergency": bool(emergency), "files": files}).encode(),
        prefix + ".pdmeta")


def _prune_epoch_ckpts(save_dir, max_to_keep):
    """Keep the newest ``max_to_keep`` epoch checkpoints (None or 0: all)."""
    if not max_to_keep:
        return
    epochs = _epoch_ckpts(save_dir)
    for e in epochs[:-int(max_to_keep)] if len(epochs) > int(max_to_keep) \
            else []:
        for suffix in (".pdparams", ".pdopt", ".pdmeta"):
            try:
                os.unlink(os.path.join(save_dir, f"{e}{suffix}"))
            except OSError:
                pass


def _host(t):
    """A tensor as numpy on the host (bf16 widened to float32)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _listed(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


class Model:
    """``Model(network)``; ``prepare(optimizer, loss, metrics,
    amp_configs)``; then ``fit`` / ``evaluate`` / ``predict`` or the
    single-batch ``train_batch`` / ``eval_batch`` / ``predict_batch``."""

    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self.stop_training = False
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._amp_level = None
        self._train_step = None
        self._n_inputs = None
        self._global_step = 0
        self._dp_group = None
        self._pp_step = None

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        """Bind the optimizer, the loss, the metrics and the AMP level:
        ``amp_configs`` "O1" / "O2" or ``{"level": ...}`` runs the
        training forward under ``auto_cast(level, dtype="bfloat16")``."""
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = metrics if isinstance(metrics, (list, tuple)) else (
            [metrics] if metrics else [])
        if isinstance(amp_configs, str):
            self._amp_level = amp_configs
        elif isinstance(amp_configs, dict):
            self._amp_level = amp_configs.get("level", "O1")
        else:
            self._amp_level = None
        self._train_step = None  # a step bound to the previous optimizer

    # -- single-batch ops ------------------------------------------------
    def _device(self):
        return next(self.network.parameters()).device

    def _on_device(self, xs):
        dev = self._device()
        return [torch.as_tensor(x).to(dev) for x in xs]

    def _compute_loss(self, outputs, labels):
        if self._loss is None:
            return outputs
        if isinstance(labels, (list, tuple)):
            return self._loss(outputs, *labels)
        return self._loss(outputs, labels)

    def _step(self, *args):
        """One training step, the body ``TrainStep`` runs: the forward (and
        the loss) under auto_cast, the backward outside it, as in the
        reference, then the update."""
        ins, labs = args[:self._n_inputs], args[self._n_inputs:]
        amp = (auto_cast(enable=True, level=self._amp_level,
                         dtype="bfloat16")
               if self._amp_level else contextlib.nullcontext())
        with amp, RecordEvent("forward"):
            out = self.network(*ins)
            loss = self._compute_loss(out, list(labs) if len(labs) > 1
                                      else labs[0])
        with RecordEvent("backward"):
            loss.backward()
        self._optimizer.step()
        self._optimizer.clear_grad()
        return loss

    def train_batch(self, inputs, labels=None, update=True):
        """One step on one batch; returns ``[loss]`` as a float (a host
        read). The ``nan_loss`` fault point fires here: at its step the
        step runs and NaN is returned in place of its loss."""
        self.network.train()
        inputs_l = _listed(inputs)
        labels_l = _listed(labels) if labels is not None else []
        if self._train_step is None:
            self._n_inputs = len(inputs_l)
            hcg = fleet.get_hybrid_communicate_group()
            if hcg is not None and hcg.get_pipe_parallel_world_size() > 1:
                self._train_step = self._pipeline_step(hcg)
            else:
                self._distribute()
                self._train_step = TrainStep(self._step, self.network,
                                             self._optimizer)
        args = [*inputs_l, *labels_l]
        if self._pp_step is not None:
            loss = self._train_step(*args)
            self._global_step += 1
            return [float(loss)]
        if self._dp_group is not None:
            args = [spmd.shard_batch(torch.as_tensor(a)) for a in args]
        with RecordEvent("train_step"):
            loss = self._train_step(*args)
        gstep = self._global_step
        self._global_step = gstep + 1
        if _faults.ACTIVE and _faults.fire("nan_loss", step=gstep):
            return [float("nan")]
        if self._dp_group is not None:
            loss = loss.detach().clone()
            collective.all_reduce(loss, collective.ReduceOp.AVG,
                                  group=self._dp_group)
        return [float(loss.detach())]

    def _pipeline_step(self, hcg):
        """The pipeline branch (module docstring)."""
        from ..distributed import pp_spmd

        if self._n_inputs != 1:
            raise ValueError(
                "the SPMD pipeline step takes exactly one input and one "
                f"label tensor (tokens, labels); got {self._n_inputs} "
                "inputs")
        if self._amp_level:
            raise ValueError(
                "amp_configs is not supported on the SPMD pipeline path "
                "yet — drop amp_configs, or set the model dtype to "
                "'bfloat16' directly (GPTConfig(dtype='bfloat16'))")
        step = pp_spmd.PipelineSpmdStep(self.network, self._optimizer,
                                        criterion=self._loss, hcg=hcg)
        self._pp_step = step

        def run(*args):
            if len(args) != 2:
                raise ValueError(
                    "the SPMD pipeline step supports exactly (tokens, "
                    f"labels); got {len(args)} tensors — multi-label "
                    "batches (e.g. loss_mask) need the engine path or a "
                    "criterion closed over the extra inputs")
            return step.train_batch(list(args))

        return run

    def _whole(self):
        """Make the network whole after pipeline training (every stage's
        blocks on every rank)."""
        if self._pp_step is not None:
            self._pp_step.sync_params_to_model()

    def _distribute(self):
        """Under ``fleet.init`` over several processes, the network sharded
        in place (once per model; see the module's docstring)."""
        hcg = fleet.get_hybrid_communicate_group()
        if hcg is None or hcg.nranks <= 1:
            return
        fleet._shard_in_place(self.network, hcg)
        self._dp_group = hcg.get_batch_group()

    def eval_batch(self, inputs, labels=None):
        """``(outputs, {"loss": float or None})`` without gradients."""
        self._whole()
        self.network.eval()
        with torch.no_grad():
            out = self.network(*self._on_device(_listed(inputs)))
            res = {"loss": None}
            if labels is not None and self._loss is not None:
                labs = self._on_device(_listed(labels))
                res["loss"] = float(self._compute_loss(
                    out, labs if isinstance(labels, (list, tuple))
                    else labs[0]))
        return out, res

    def predict_batch(self, inputs):
        self._whole()
        self.network.eval()
        with torch.no_grad():
            return self.network(*self._on_device(_listed(inputs)))

    # -- loops -----------------------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            resume=False, max_ckpt_to_keep=5, elastic=None, **kwargs):
        """Train for ``epochs`` over ``train_data`` (a ``DataLoader``, or a
        dataset batched here with ``batch_size``, ``shuffle``,
        ``drop_last`` and ``num_workers``); returns one log dict per epoch.

        - ``save_dir``: a checkpoint every ``save_freq`` epochs, the newest
          ``max_ckpt_to_keep`` kept (None or 0: all).
        - ``resume=True``: start after the newest checkpoint in
          ``save_dir`` whose files verify (params, optimizer slots, RNG
          states); corrupt or partial ones are skipped with a
          ``checkpoint_skip`` event. An emergency checkpoint re-runs its
          epoch.
        - SIGTERM while training (on the main thread): an emergency
          checkpoint at the next batch boundary, then ``fit`` returns.
        - ``elastic``: an ``ElasticTrainContext``. Each batch ticks its
          step boundary; a preemption announced by any rank takes this
          rank's emergency checkpoint too; a failed fence check stops
          training and nothing more is written to ``save_dir``.
        """
        from .callbacks import CallbackList, ProgBarLogger

        loader = train_data if isinstance(train_data, DataLoader) else \
            DataLoader(train_data, batch_size=batch_size, shuffle=shuffle,
                       drop_last=drop_last, num_workers=num_workers)
        cbs = CallbackList((callbacks or []) +
                           [ProgBarLogger(log_freq, verbose)])
        for cb in cbs.callbacks:
            cb.set_model(self)
        start_epoch = 0
        if resume and save_dir:
            start_epoch = self._resume_from(save_dir)
        self._preempt_requested = False
        on_main = threading.current_thread() is threading.main_thread()
        if on_main:
            def _on_sigterm(signum, frame):
                self._preempt_requested = True

            # None: a handler not set from Python; the default stands in
            old_sigterm = signal.signal(signal.SIGTERM, _on_sigterm) \
                or signal.SIG_DFL
        try:
            return self._fit_loop(loader, cbs, eval_data, batch_size,
                                  start_epoch, epochs, eval_freq, save_dir,
                                  save_freq, max_ckpt_to_keep,
                                  elastic=elastic)
        finally:
            # a raising batch or callback must not leave the process deaf
            # to SIGTERM
            if on_main:
                signal.signal(signal.SIGTERM, old_sigterm)

    def _fit_loop(self, loader, cbs, eval_data, batch_size, start_epoch,
                  epochs, eval_freq, save_dir, save_freq, max_ckpt_to_keep,
                  elastic=None):
        cbs.on_train_begin()
        history = []
        fenced = False
        global_step = 0
        for epoch in range(start_epoch, epochs):
            if self.stop_training:
                break
            cbs.on_epoch_begin(epoch)
            it = iter(loader)
            step = -1
            logs = {}  # an epoch of no batches still closes
            while True:
                # the wait for a batch is a span of its own
                ev = RecordEvent("dataloader")
                ev.begin()
                try:
                    batch = next(it, _END)
                finally:
                    ev.end()
                if batch is _END:
                    break
                step += 1
                cbs.on_train_batch_begin(step)
                *xs, y = batch if isinstance(batch, (list, tuple)) else [batch]
                loss = self.train_batch(xs, y)
                logs = {"loss": loss[0]}
                if self._optimizer is not None:
                    logs["lr"] = float(self._optimizer.get_lr())
                cbs.on_train_batch_end(step, logs)
                if elastic is not None:
                    global_step += 1
                    elastic.step_boundary(global_step)
                    if elastic.preempt_requested:
                        self._preempt_requested = True  # a peer's notice
                    if not elastic.fence_check("train loop"):
                        fenced = True  # resized out: stop, write nothing
                        break
                if self._preempt_requested:
                    break
            history.append(dict(logs))
            if fenced:
                self.stop_training = True
                cbs.on_epoch_end(epoch, logs)
                break
            if self._preempt_requested:
                # the emergency checkpoint at the batch boundary just
                # closed, then a clean return inside the grace period
                if save_dir and (elastic is None or
                                 elastic.fence_check("emergency ckpt")):
                    self._save_epoch_ckpt(save_dir, epoch, max_ckpt_to_keep,
                                          emergency=True, step=step)
                self.stop_training = True
                cbs.on_epoch_end(epoch, logs)
                break
            cbs.on_epoch_end(epoch, logs)
            if eval_data is not None and (epoch + 1) % eval_freq == 0:
                cbs.on_eval_begin()
                eval_logs = self.evaluate(eval_data, batch_size=batch_size,
                                          verbose=0, callbacks=cbs)
                history[-1].update({f"eval_{k}": v
                                    for k, v in eval_logs.items()
                                    if v is not None})
                cbs.on_eval_end(eval_logs)
            if save_dir and (epoch + 1) % save_freq == 0 and (
                    elastic is None
                    or elastic.fence_check("epoch checkpoint")):
                self._save_epoch_ckpt(save_dir, epoch, max_ckpt_to_keep)
        cbs.on_train_end()
        return history

    def _save_epoch_ckpt(self, save_dir, epoch, max_to_keep,
                         emergency=False, step=None):
        prefix = f"{save_dir}/{epoch}"
        self.save(prefix)
        _write_epoch_meta(prefix, epoch, self.network, emergency=emergency)
        if emergency:
            _explain.record(
                "checkpoint_save", op="emergency",
                why=f"SIGTERM: emergency epoch checkpoint at epoch {epoch}"
                    + (f", batch {step}" if step is not None else ""),
                epoch=epoch)
        _prune_epoch_ckpts(save_dir, max_to_keep)

    def _resume_from(self, save_dir):
        """Restore the newest epoch checkpoint in ``save_dir`` that
        verifies and return the epoch to start at (0 when none does). The
        ``.pdmeta`` is the commit marker: params without it are a save cut
        short and never restore; a file whose crc32 or size disagrees with
        it is skipped. An emergency checkpoint re-runs its epoch."""
        for epoch in reversed(_epoch_ckpts(save_dir)):
            prefix = f"{save_dir}/{epoch}"
            try:
                with open(prefix + ".pdmeta") as f:
                    meta = json.load(f)
                # integrity first: a torn file must not half-restore
                for suffix, rec in (meta.get("files") or {}).items():
                    with open(prefix + suffix, "rb") as f:
                        blob = f.read()
                    if len(blob) != rec.get("bytes") or \
                            zlib.crc32(blob) != rec.get("crc32"):
                        raise RuntimeError(
                            f"{prefix}{suffix} fails its checksum")
                self.load(prefix)
            except (RuntimeError, OSError, ValueError) as e:
                _explain.record(
                    "checkpoint_skip", op="fit_resume",
                    why=f"skipping epoch {epoch} checkpoint: {e}",
                    epoch=epoch)
                continue
            _rng_restore(meta, self.network)
            if meta.get("np_rng"):
                name, keys, pos, has_gauss, cached = meta["np_rng"]
                np.random.set_state((name, np.asarray(keys, np.uint32), pos,
                                     has_gauss, cached))
            start = epoch if meta.get("emergency") else epoch + 1
            _explain.record(
                "checkpoint_restore", op="fit_resume",
                why=f"resuming at epoch {start} from {prefix}"
                    + (" (emergency: re-running the interrupted epoch)"
                       if meta.get("emergency") else ""),
                epoch=epoch)
            return start
        return 0

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None):
        """``{"loss": mean loss or None, <metric name>: value, ...}`` over
        ``eval_data``."""
        loader = eval_data if isinstance(eval_data, DataLoader) else \
            DataLoader(eval_data, batch_size=batch_size,
                       num_workers=num_workers)
        cbs = callbacks
        for m in self._metrics:
            m.reset()
        losses = []
        for step, batch in enumerate(loader):
            if cbs is not None:
                cbs.on_eval_batch_begin(step)
            *xs, y = batch if isinstance(batch, (list, tuple)) else [batch]
            out, res = self.eval_batch(xs, y)
            if res["loss"] is not None:
                losses.append(res["loss"])
            for m in self._metrics:
                # Metric.compute returns its arguments as a tuple when a
                # metric has nothing to compute first: they are update's
                r = m.compute(out, y)
                if isinstance(r, tuple):
                    m.update(*r)
                else:
                    m.update(r)
            if cbs is not None:
                cbs.on_eval_batch_end(step, res)
        logs = {"loss": float(np.mean(losses)) if losses else None}
        for m in self._metrics:
            name = m.name()
            acc = m.accumulate()
            if isinstance(name, (list, tuple)):
                for n, a in zip(name, acc if isinstance(
                        acc, (list, tuple)) else [acc]):
                    logs[n] = a
            else:
                logs[name] = acc
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None, verbose=1):
        """The network's outputs over ``test_data`` as numpy: ``[[batch
        outputs...]]``, or ``[one array]`` with ``stack_outputs``. A batch
        of more than one field is taken as inputs and a label."""
        loader = test_data if isinstance(test_data, DataLoader) else \
            DataLoader(test_data, batch_size=batch_size,
                       num_workers=num_workers)
        outs = []
        for batch in loader:
            xs = batch[:-1] if isinstance(batch, (list, tuple)) and \
                len(batch) > 1 else _listed(batch)
            outs.append(_host(self.predict_batch(xs)))
        if stack_outputs:
            return [np.concatenate(outs)]
        return [outs]

    # -- persistence -----------------------------------------------------
    def save(self, path, training=True):
        """``path.pdparams`` (and, with ``training``, ``path.pdopt``) in the
        reference's format and layout (``convert``). After pipeline
        training every rank calls it and the first rank writes."""
        if self._pp_step is not None:
            self._save_pipeline(path, training)
            return
        framework.save(convert.state_to_paddle_tpu(self.network),
                       path + ".pdparams")
        if training and self._optimizer is not None:
            framework.save(convert.optimizer_state_to_paddle_tpu(
                self._optimizer, self.network), path + ".pdopt")

    def _save_pipeline(self, path, training):
        from ..distributed import parallel_env

        step = self._pp_step
        state = convert.state_to_paddle_tpu(self.network, step.state_dict())
        opt_state = None if not training else \
            convert.optimizer_state_to_paddle_tpu(
                step.optimizer, self.network,
                step.export_optimizer_state(), step.runner.full_list)
        if parallel_env.get_rank() != 0:
            return
        framework.save(state, path + ".pdparams")
        if opt_state is not None:
            framework.save(opt_state, path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        """Restore the parameters, and the optimizer's state when a
        ``.pdopt`` exists and ``reset_optimizer`` is False; either package's
        files. Copies in place, so a captured training step stays valid.
        ``reset_optimizer=True`` drops every slot and the step count (fine
        tuning from pretrained weights must not inherit stale moments).
        A pipeline step is retired first; the next ``train_batch`` builds
        a new one."""
        if self._pp_step is not None:
            self._pp_step.release()
            self._pp_step = self._train_step = None
        convert.load_paddle_tpu_state(self.network,
                                      framework.load(path + ".pdparams"))
        opt = self._optimizer
        if opt is None:
            return
        if reset_optimizer:
            opt._accumulators = {}
            opt._opt_step = 0
            self._train_step = None  # its graph holds the dropped slots
        elif os.path.exists(path + ".pdopt"):
            opt.set_state_dict(convert.optimizer_state_from_paddle_tpu(
                framework.load(path + ".pdopt"), opt, self.network))

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        n_params = sum(p.numel() for p in self.network.parameters())
        return f"{type(self.network).__name__}: {n_params:,} parameters"
