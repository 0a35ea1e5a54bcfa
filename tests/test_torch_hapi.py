"""paddle_tpu_torch.hapi (Model, callbacks) and paddle_tpu_torch.metric
against paddle_tpu on the CPU.

- ``fit`` over 2 epochs with SGD (``gpt2-tiny``, ``n_head=2``, vocab 96,
  weights carried by ``convert``, shuffled under one ``np.random.seed``):
  every batch's loss and the final parameters within 1e-5 of the
  reference's ``fit``. With AdamW the port is held against the
  reference's eager step body (losses and parameters within 1e-4, as in
  ``test_torch_train_step.py``): the reference's ``fit`` runs its
  ``TrainStep``, which counts Adam's step twice (ROADMAP queue 3; shown
  here too).
- ``evaluate`` / ``predict`` and the four metrics on a small classifier:
  within 1e-5 (metrics exact).
- Each callback against the reference's.
- Epoch checkpoints: retention, resume bitwise equal to an uninterrupted
  run, a torn file skipped, the SIGTERM emergency checkpoint; a
  ``save_dir`` written by the reference's ``fit`` resumed by the port with
  equal parameters, and the other way round.
- ``nan_loss`` fires at ``train_batch``; ``fit(elastic=...)`` ticks the
  context and checks its fence.
"""
import json
import os
import signal

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import hapi as jhapi  # noqa: E402
from paddle_tpu import io as jio  # noqa: E402
from paddle_tpu import metric as jmetric  # noqa: E402
from paddle_tpu.models import gpt as jgpt  # noqa: E402
from paddle_tpu_torch import callbacks as tcallbacks  # noqa: E402
from paddle_tpu_torch import convert, hapi, io  # noqa: E402
from paddle_tpu_torch import metric as tmetric  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch.models import gpt as tgpt  # noqa: E402
from paddle_tpu_torch.profiler import explainer  # noqa: E402
from paddle_tpu_torch.testing import faults  # noqa: E402

# one intra-op thread: the suite's parallel workers share the CPU, and
# a torch thread pool in each would oversubscribe it
torch.set_num_threads(1)

VOCAB = 96
CFG = dict(vocab_size=VOCAB, n_head=2, dropout=0.0)
TOKS = np.random.default_rng(0).integers(0, VOCAB, (8, 129))


def _ref_gpt():
    state = paddle.get_rng_state()
    try:
        paddle.seed(0)
        return jgpt.GPTForPretraining(jgpt.GPTModel(
            jgpt.GPTConfig.preset("gpt2-tiny", **CFG)))
    finally:
        paddle.set_rng_state(state)


def _ref_state(layer):
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


def _port_gpt(state):
    m = tgpt.GPTForPretraining(tgpt.GPTModel(
        tgpt.GPTConfig.preset("gpt2-tiny", **CFG), device="cpu"))
    convert.load_paddle_tpu_state(m, state)
    return m


def _dataset(pkg):
    return pkg.TensorDataset([TOKS[:, :-1], TOKS[:, 1:]])


def _recorder(base):
    class Recorder(base):
        def __init__(self):
            self.losses, self.lrs = [], []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])
            self.lrs.append(logs.get("lr"))

    return Recorder()


def _port_model(state, opt="sgd", amp=None, lr=0.1):
    net = _port_gpt(state)
    if opt == "sgd":
        o = topt.SGD(learning_rate=lr, parameters=net.parameters())
    else:
        o = topt.AdamW(learning_rate=lr, parameters=net.parameters())
    m = hapi.Model(net)
    m.prepare(o, tgpt.GPTPretrainingCriterion(), amp_configs=amp)
    return m


def _assert_state_close(tm, ref_state, tol):
    got = convert.state_to_paddle_tpu(tm)
    for k, want in ref_state.items():
        np.testing.assert_allclose(got[k].detach().numpy(), want, atol=tol,
                                   rtol=tol, err_msg=k)


@pytest.fixture(scope="module")
def reference_fit(tmp_path_factory):
    """The reference's ``fit`` with SGD over 2 epochs (shuffled, seed 0),
    its save_dir kept: initial state, per-batch losses, final state."""
    save_dir = str(tmp_path_factory.mktemp("ref_fit"))
    jm = _ref_gpt()
    init = _ref_state(jm)
    model = jhapi.Model(jm)
    model.prepare(paddle.optimizer.SGD(learning_rate=0.1,
                                       parameters=jm.parameters()),
                  jgpt.GPTPretrainingCriterion())
    rec = _recorder(jhapi.callbacks.Callback)
    np.random.seed(0)
    model.fit(_dataset(jio), batch_size=2, epochs=2, verbose=0,
              save_dir=save_dir, callbacks=[rec])
    return {"init": init, "losses": rec.losses, "final": _ref_state(jm),
            "save_dir": save_dir}


@pytest.mark.parametrize("num_workers", [0, 2])
def test_fit_losses_with_sgd_match_reference(reference_fit, num_workers):
    m = _port_model(reference_fit["init"])
    rec = _recorder(tcallbacks.Callback)
    np.random.seed(0)
    hist = m.fit(_dataset(io), batch_size=2, epochs=2, verbose=0,
                 num_workers=num_workers, callbacks=[rec])
    assert len(hist) == 2 and len(rec.losses) == 8
    np.testing.assert_allclose(rec.losses, reference_fit["losses"],
                               atol=1e-5, rtol=1e-5)
    _assert_state_close(m.network, reference_fit["final"], 1e-5)


def _ref_eager_adamw(init, batches, lr):
    jm = _ref_gpt()
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in init.items()})
    opt = paddle.optimizer.AdamW(learning_rate=lr,
                                 parameters=jm.parameters())
    crit = jgpt.GPTPretrainingCriterion()
    losses = []
    for x, y in batches:
        loss = crit(jm(paddle.to_tensor(x)), paddle.to_tensor(y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return jm, losses


def test_fit_with_adamw_matches_reference_eager_step(reference_fit):
    lr = 1e-3
    batches = [(TOKS[i:i + 2, :-1], TOKS[i:i + 2, 1:]) for i in (0, 2, 4, 6)]
    jm, want = _ref_eager_adamw(reference_fit["init"], batches, lr)
    m = _port_model(reference_fit["init"], opt="adamw", lr=lr)
    rec = _recorder(tcallbacks.Callback)
    m.fit(_dataset(io), batch_size=2, epochs=1, shuffle=False, verbose=0,
          callbacks=[rec])
    np.testing.assert_allclose(rec.losses, want, atol=1e-4, rtol=1e-4)
    _assert_state_close(m.network, _ref_state(jm), 1e-4)
    assert m._optimizer._opt_step == 4  # counted once per step


def test_reference_fit_counts_adam_steps_twice(reference_fit):
    """The reference's fault, which the port does not copy: its ``fit``
    runs ``jit.TrainStep``, which advances Adam's step count twice a call,
    so its AdamW leaves its own eager loop after the first step."""
    lr = 1e-3
    batches = [(TOKS[i:i + 2, :-1], TOKS[i:i + 2, 1:]) for i in (0, 2)]
    jm_eager, _ = _ref_eager_adamw(reference_fit["init"], batches, lr)
    jm = _ref_gpt()
    model = jhapi.Model(jm)
    opt = paddle.optimizer.AdamW(learning_rate=lr,
                                 parameters=jm.parameters())
    model.prepare(opt, jgpt.GPTPretrainingCriterion())
    model.fit(jio.TensorDataset([TOKS[:4, :-1], TOKS[:4, 1:]]),
              batch_size=2, epochs=1, shuffle=False, verbose=0)
    assert opt._opt_step == 4
    diff = max(np.abs(a - b).max() for a, b in zip(
        _ref_state(jm).values(), _ref_state(jm_eager).values()))
    assert diff > 1e-5


# ----------------------------------------------------------- classifier --
def _clf_data(n=48, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 4)).astype(np.float32)
    return x, (x.sum(1) > 0).astype(np.int64)


@pytest.fixture(scope="module")
def classifiers():
    """Factories of the same small classifier in both packages."""
    jnet = paddle.nn.Sequential(paddle.nn.Linear(4, 8), paddle.nn.ReLU(),
                                paddle.nn.Linear(8, 2))
    state = _ref_state(jnet)

    def ref_net():
        net = paddle.nn.Sequential(paddle.nn.Linear(4, 8), paddle.nn.ReLU(),
                                   paddle.nn.Linear(8, 2))
        net.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
        return net

    def port_net():
        net = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.ReLU(),
                                  torch.nn.Linear(8, 2))
        convert.load_paddle_tpu_state(net, state)
        return net

    return ref_net, port_net


def _port_clf(port_net, metrics=None, sched=None):
    net = port_net()
    m = hapi.Model(net)
    m.prepare(topt.SGD(learning_rate=sched or 0.1,
                       parameters=net.parameters()),
              torch.nn.CrossEntropyLoss(), metrics=metrics)
    return m


def _ref_clf(ref_net, metrics=None, sched=None):
    jnet = ref_net()
    m = jhapi.Model(jnet)
    m.prepare(paddle.optimizer.SGD(learning_rate=sched or 0.1,
                                   parameters=jnet.parameters()),
              paddle.nn.CrossEntropyLoss(), metrics=metrics)
    return m


def test_evaluate_predict_and_metrics_match_reference(classifiers):
    ref_net, port_net = classifiers
    x, y = _clf_data()
    tm = _port_clf(port_net, metrics=tmetric.Accuracy(topk=(1, 2)))
    jm = _ref_clf(ref_net, metrics=jmetric.Accuracy(topk=(1, 2)))
    got = tm.evaluate(io.TensorDataset([x, y]), batch_size=16)
    want = jm.evaluate(jio.TensorDataset([x, y]), batch_size=16)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5)
    tp = tm.predict(io.TensorDataset([x, y]), batch_size=16,
                    stack_outputs=True)[0]
    jp = jm.predict(jio.TensorDataset([x, y]), batch_size=16,
                    stack_outputs=True)[0]
    np.testing.assert_allclose(tp, jp, rtol=1e-5, atol=1e-5)
    # the four metrics on the same scores and labels
    rng = np.random.default_rng(4)
    scores = rng.random((40, 3)).astype(np.float32)
    probs = rng.random(40).astype(np.float32)
    labels = rng.integers(0, 2, 40)
    for name, make, feed in (
            ("accuracy", lambda mod: mod.Accuracy(topk=(1, 2)), None),
            ("precision", lambda mod: mod.Precision(), (probs, labels)),
            ("recall", lambda mod: mod.Recall(), (probs, labels)),
            ("auc", lambda mod: mod.Auc(num_thresholds=255),
             (np.stack([1 - probs, probs], 1), labels))):
        out = []
        for mod in (tmetric, jmetric):
            m = make(mod)
            if feed is None:
                m.update(m.compute(scores, labels))
            else:
                m.update(*feed)
            out.append(m.accumulate())
        assert out[0] == out[1], name
    got = tmetric.accuracy(torch.from_numpy(scores), torch.from_numpy(labels),
                           k=2)
    want = jmetric.accuracy(paddle.to_tensor(scores),
                            paddle.to_tensor(labels), k=2)
    assert float(got) == float(want)


def test_evaluate_takes_a_metric_without_compute():
    """Precision has no compute step: the port's evaluate updates it with
    the outputs and labels. The reference's passes it one tuple and raises
    (ROADMAP queue 3)."""
    x, y = _clf_data()
    net = torch.nn.Sequential(torch.nn.Linear(4, 1), torch.nn.Sigmoid())
    tm = hapi.Model(net)
    tm.prepare(metrics=tmetric.Precision())
    logs = tm.evaluate(io.TensorDataset([x, y]), batch_size=16)
    direct = tmetric.Precision()
    direct.update(net(torch.from_numpy(x)).detach(), y)
    assert logs == {"loss": None, "precision": direct.accumulate()}
    jm = jhapi.Model(paddle.nn.Sequential(paddle.nn.Linear(4, 1),
                                          paddle.nn.Sigmoid()))
    jm.prepare(metrics=jmetric.Precision())
    with pytest.raises(TypeError):
        jm.evaluate(jio.TensorDataset([x, y]), batch_size=16)


def _fit_both(classifiers, make_cbs, epochs=3, **fit_kw):
    """The same fit in both packages: ``make_cbs(pkg)`` gives its
    callbacks and extra ``prepare`` arguments. Returns ``[(model,
    callbacks, history)]``, the port's first."""
    ref_net, port_net = classifiers
    x, y = _clf_data()
    runs = []
    for io_mod, make_model, net in ((io, _port_clf, port_net),
                                    (jio, _ref_clf, ref_net)):
        cbs, model_kw = make_cbs("port" if io_mod is io else "ref")
        m = make_model(net, **model_kw)
        np.random.seed(1)
        hist = m.fit(io_mod.TensorDataset([x, y]), batch_size=16,
                     epochs=epochs, verbose=0, callbacks=cbs, **fit_kw)
        runs.append((m, cbs, hist))
    return runs


def test_lr_scheduler_and_progbar_callbacks_match_reference(classifiers,
                                                             capsys):
    def make(pkg):
        lr = (topt.lr if pkg == "port" else paddle.optimizer.lr).StepDecay(
            0.1, step_size=2, gamma=0.5)
        cbm = tcallbacks if pkg == "port" else jhapi.callbacks
        return ([cbm.LRScheduler(by_step=True),
                 _recorder(cbm.Callback)], {"sched": lr})

    (tm, tcbs, thist), (jm, jcbs, jhist) = _fit_both(classifiers, make)
    lrs = tcbs[1].lrs
    assert lrs == jcbs[1].lrs and len(set(lrs)) > 2
    # the losses agree up to the first step taken at a new rate: the
    # reference's TrainStep keeps the first rate it traced (ROADMAP queue
    # 3), the port's reads the scheduler before every step
    first_new = lrs.index(lrs[0] * 0.5) + 1
    np.testing.assert_allclose(tcbs[1].losses[:first_new],
                               jcbs[1].losses[:first_new], atol=1e-5,
                               rtol=1e-5)
    assert tcbs[1].losses[first_new] != pytest.approx(
        jcbs[1].losses[first_new], abs=1e-4)
    # ProgBarLogger: the same lines from the same logs (times aside)
    lines = []
    for cbm in (tcallbacks, jhapi.callbacks):
        bar = cbm.ProgBarLogger(log_freq=2, verbose=1)
        bar.on_epoch_begin(0)
        for step in range(4):
            bar.on_train_batch_end(step, {"loss": 0.5 + step, "lr": 0.1})
        bar.on_epoch_end(0)
        lines.append([ln.split(" done in")[0] for ln in
                      capsys.readouterr().out.splitlines()])
    assert lines[0] == lines[1] and len(lines[0]) == 3


def test_early_stopping_and_reduce_lr_match_reference(classifiers):
    def make(pkg):
        cbm = tcallbacks if pkg == "port" else jhapi.callbacks
        hc = hapi.callbacks if pkg == "port" else jhapi.callbacks
        return ([cbm.EarlyStopping(monitor="loss", patience=1, verbose=0,
                                   min_delta=10.0),
                 hc.ReduceLROnPlateau(monitor="loss", factor=0.5,
                                      patience=1, verbose=0, min_delta=10.0),
                 _recorder(cbm.Callback)], {})

    (tm, tcbs, thist), (jm, jcbs, jhist) = _fit_both(classifiers, make,
                                                     epochs=6)
    assert tm.stop_training and jm.stop_training
    assert len(thist) == len(jhist) == tcbs[0].stopped_epoch + 1
    assert tcbs[0].stopped_epoch == jcbs[0].stopped_epoch
    assert tcbs[2].lrs == jcbs[2].lrs and tcbs[2].lrs[-1] < 0.1
    # save_best_model restored the weights of the best (first) epoch
    assert tcbs[0].best_weights is not None


def test_checkpoint_and_visualdl_callbacks_match_reference(classifiers,
                                                           tmp_path):
    def make(pkg):
        d = tmp_path / pkg
        cbm = tcallbacks if pkg == "port" else jhapi.callbacks
        hc = hapi.callbacks if pkg == "port" else jhapi.callbacks
        return ([cbm.ModelCheckpoint(save_freq=1, save_dir=str(d / "ck")),
                 hc.VisualDL(log_dir=str(d / "vdl"))], {})

    _fit_both(classifiers, make, epochs=2)
    for name in ("0", "1", "final"):
        for suffix in (".pdparams", ".pdopt"):
            assert (tmp_path / "port" / "ck" / f"{name}{suffix}").exists()
    scal = [[json.loads(ln) for ln in (tmp_path / pkg / "vdl" /
                                       "scalars.jsonl").read_text()
             .splitlines()] for pkg in ("port", "ref")]
    assert [(r["tag"], r["step"]) for r in scal[0]] == \
        [(r["tag"], r["step"]) for r in scal[1]]
    np.testing.assert_allclose([r["value"] for r in scal[0]],
                               [r["value"] for r in scal[1]], atol=1e-5,
                               rtol=1e-5)
    # the port's final checkpoint loads into the reference
    jm = _ref_clf(classifiers[0])
    jm.load(str(tmp_path / "port" / "ck" / "final"))


# ---------------------------------------------------------- checkpoints --
def _slots(opt):
    return {k: v.clone() for k, v in opt.state_dict().items()
            if isinstance(v, torch.Tensor)}


def test_resume_is_bitwise_and_retention_keeps_one(reference_fit, tmp_path):
    init = reference_fit["init"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    full = _port_model(init, opt="adamw", lr=1e-3)
    rec_full = _recorder(tcallbacks.Callback)
    np.random.seed(3)
    full.fit(_dataset(io), batch_size=2, epochs=2, save_dir=a, verbose=0,
             max_ckpt_to_keep=1, callbacks=[rec_full])
    assert sorted(os.listdir(a)) == ["1.pdmeta", "1.pdopt", "1.pdparams"]
    first = _port_model(init, opt="adamw", lr=1e-3)
    np.random.seed(3)
    first.fit(_dataset(io), batch_size=2, epochs=1, save_dir=b, verbose=0)
    np.random.seed(123)  # the checkpoint's numpy state must win
    resumed = _port_model(init, opt="adamw", lr=1e-3)
    rec = _recorder(tcallbacks.Callback)
    resumed.fit(_dataset(io), batch_size=2, epochs=2, save_dir=b,
                resume=True, verbose=0, callbacks=[rec])
    assert rec.losses == rec_full.losses[4:]
    for (k, p), q in zip(full.network.state_dict().items(),
                         resumed.network.state_dict().values()):
        assert torch.equal(p, q), k
    s1, s2 = _slots(full._optimizer), _slots(resumed._optimizer)
    assert s1.keys() == s2.keys()
    assert all(torch.equal(s1[k], s2[k]) for k in s1)
    assert full._optimizer._opt_step == resumed._optimizer._opt_step == 8


def test_torn_checkpoint_is_skipped(reference_fit, tmp_path):
    d = str(tmp_path)
    m = _port_model(reference_fit["init"])
    m.fit(_dataset(io), batch_size=2, epochs=2, save_dir=d, verbose=0,
          shuffle=False)
    with open(os.path.join(d, "1.pdparams"), "r+b") as f:
        f.truncate(100)
    r = _port_model(reference_fit["init"])
    n0 = len(explainer.events(kind="checkpoint_skip"))
    assert r._resume_from(d) == 1  # epoch 0's checkpoint
    skips = explainer.events(kind="checkpoint_skip")[n0:]
    assert len(skips) == 1 and skips[0]["epoch"] == 1
    # params without their .pdmeta (a save cut short) never restore
    os.unlink(os.path.join(d, "0.pdmeta"))
    assert _port_model(reference_fit["init"])._resume_from(d) == 0


def test_sigterm_writes_an_emergency_checkpoint(reference_fit, tmp_path):
    d = str(tmp_path)

    class Preempt(tcallbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            if step == 1:
                os.kill(os.getpid(), signal.SIGTERM)

    before = signal.getsignal(signal.SIGTERM)
    m = _port_model(reference_fit["init"])
    hist = m.fit(_dataset(io), batch_size=2, epochs=3, save_dir=d, verbose=0,
                 shuffle=False, callbacks=[Preempt()])
    assert signal.getsignal(signal.SIGTERM) is before
    assert m.stop_training and len(hist) == 1
    with open(os.path.join(d, "0.pdmeta")) as f:
        meta = json.load(f)
    assert meta["emergency"] and meta["epoch"] == 0
    assert explainer.events(kind="checkpoint_save")[-1]["op"] == "emergency"
    # the interrupted epoch runs again on resume
    assert _port_model(reference_fit["init"])._resume_from(d) == 0


def test_reference_save_dir_resumes_in_the_port_and_back(reference_fit,
                                                         tmp_path):
    m = _port_model(reference_fit["init"])
    n0 = len(explainer.events(kind="checkpoint_rng_skipped"))
    hist = m.fit(_dataset(io), batch_size=2, epochs=2,
                 save_dir=reference_fit["save_dir"], resume=True, verbose=0)
    assert hist == []  # both epochs were done: nothing to train
    assert len(explainer.events(kind="checkpoint_rng_skipped")) == n0 + 1
    _assert_state_close(m.network, reference_fit["final"], 0.0)
    # a port save_dir resumed by the reference
    d = str(tmp_path)
    _port_model(reference_fit["init"]).fit(
        _dataset(io), batch_size=2, epochs=1, save_dir=d, verbose=0)
    saved = convert.state_to_paddle_tpu(
        _port_model(reference_fit["init"]).network)
    jm = _ref_gpt()
    jmodel = jhapi.Model(jm)
    jmodel.prepare(paddle.optimizer.SGD(learning_rate=0.1,
                                        parameters=jm.parameters()),
                   jgpt.GPTPretrainingCriterion())
    assert jmodel._resume_from(d) == 1
    port_final = _port_model(reference_fit["init"])
    port_final.load(os.path.join(d, "0"))
    want = convert.state_to_paddle_tpu(port_final.network)
    for k, v in _ref_state(jm).items():
        np.testing.assert_array_equal(v, want[k].detach().numpy(), k)
    assert any(not torch.equal(saved[k], want[k]) for k in saved)


def test_nan_loss_fires_at_train_batch_and_training_goes_on(reference_fit):
    m = _port_model(reference_fit["init"])
    rec = _recorder(tcallbacks.Callback)
    faults.configure("nan_loss:step=1")
    try:
        m.fit(_dataset(io), batch_size=2, epochs=1, shuffle=False,
              verbose=0, callbacks=[rec])
    finally:
        faults.reset()
    assert np.isnan(rec.losses[1])
    assert np.isfinite([rec.losses[i] for i in (0, 2, 3)]).all()
    assert m._global_step == 4


def test_fit_elastic_raises_and_summary(reference_fit):
    m = _port_model(reference_fit["init"])

    class Spy:  # duck-types ElasticTrainContext
        preempt_requested = False

        def __init__(self):
            self.ticks, self.fences = [], []

        def step_boundary(self, step):
            self.ticks.append(step)

        def fence_check(self, what=""):
            self.fences.append(what)
            return True

    # accepted and wired: one batch, one boundary tick, one fence check
    spy = Spy()
    m.fit(_dataset(io), batch_size=8, epochs=1, shuffle=False, verbose=0,
          elastic=spy)
    assert spy.ticks == [1] and spy.fences == ["train loop"]
    n = sum(p.numel() for p in m.network.parameters())
    assert m.summary() == f"GPTForPretraining: {n:,} parameters"
