"""The port's elastic training loop against the JAX package's on the CPU:
``CheckpointHook(elastic=)``, ``hapi.Model.fit(elastic=)``, the fault
points that fire at the hook, and the sharded checkpoint both packages
read.

- ``kill_at_step`` kills ``tools/elastic_gpt_trainer.py`` (``gpt2-tiny``,
  ``TrainStep``) at step 5; with its newest checkpoint torn, the resumed
  run falls back one checkpoint and ends bitwise the uninterrupted run.
- The 4 -> 3 -> 4 resize soak: each world trains past its last checkpoint
  and is "killed"; every resume merges the old world's shards
  (``load_resharded``), the torn newest checkpoint is skipped, the
  restores are in place (the storage ``TrainStep``'s graphs key on is
  unchanged, so the card's graph is kept), and the end is bitwise the
  uninterrupted run.
- A fenced zombie never writes; ``rank_preempt`` lands an emergency
  checkpoint; two ranks' coordinated preemption gives one step's
  manifests with ``coordinated == 2``.
- ``fit(elastic=)``: it stops when fenced, takes a peer's preemption, and
  writes its emergency checkpoint only under a valid fence.
- A checkpoint the port writes sharded at world 2 resumes in the
  reference's ``load_resharded`` at world 1, and the reverse: parameters
  and optimizer slots bitwise.
- One elastic leg of ``gpt2-tiny`` (a restore in place mid-run), weights
  carried by ``convert``: every loss within ``test_torch_train.py``'s
  1e-4 of the reference's uninterrupted eager loop.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.distributed.fleet import elastic as JE  # noqa: E402
from paddle_tpu.distributed.store import TCPStore as JStore  # noqa: E402
from paddle_tpu.incubate import checkpoint as jckpt  # noqa: E402
from paddle_tpu.models import gpt as jgpt  # noqa: E402
from paddle_tpu_torch import convert, hapi, io  # noqa: E402
from paddle_tpu_torch import jit as tjit  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch.callbacks import Callback  # noqa: E402
from paddle_tpu_torch.distributed.fleet import elastic as E  # noqa: E402
from paddle_tpu_torch.distributed.store import TCPStore  # noqa: E402
from paddle_tpu_torch.incubate import checkpoint as ckpt  # noqa: E402
from paddle_tpu_torch.models import gpt as tgpt  # noqa: E402
from paddle_tpu_torch.profiler import registry  # noqa: E402
from paddle_tpu_torch.testing import faults  # noqa: E402

# one intra-op thread: the suite's parallel workers share the CPU, and
# a torch thread pool in each would oversubscribe it
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINER = os.path.join(REPO, "tools", "elastic_gpt_trainer.py")
TOL = dict(atol=1e-4, rtol=1e-4)  # tests/test_torch_train.py's
VOCAB, LR = 96, 1e-3
CFG = dict(vocab_size=VOCAB, n_head=2, dropout=0.0)


@pytest.fixture(autouse=True)
def _disarm_faults():
    yield
    faults.reset()


@pytest.fixture()
def store():
    s = TCPStore("127.0.0.1", 0, is_master=True, world_size=1, timeout=10.0)
    yield s
    s.close()


def _ref_gpt(seed=0):
    state = paddle.get_rng_state()
    try:
        paddle.seed(seed)
        return jgpt.GPTForPretraining(jgpt.GPTModel(
            jgpt.GPTConfig.preset("gpt2-tiny", **CFG)))
    finally:
        paddle.set_rng_state(state)


def _np_state(layer):
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


def _port_gpt(jm=None):
    m = tgpt.GPTForPretraining(tgpt.GPTModel(
        tgpt.GPTConfig.preset("gpt2-tiny", **CFG), device="cpu"))
    return convert.load_paddle_tpu_state(m, _np_state(jm or _ref_gpt()))


def _batch(step, seq=32, b=2):
    toks = np.random.default_rng(1000 + step).integers(0, VOCAB, (b, seq + 1))
    return toks[:, :-1], toks[:, 1:]


def _port_trainer(jm=None):
    net = _port_gpt(jm)
    opt = topt.AdamW(learning_rate=LR, parameters=net.parameters())
    crit = tgpt.GPTPretrainingCriterion()

    def step_fn(tokens, labels):
        loss = crit(net(tokens), labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    return net, opt, tjit.TrainStep(step_fn, net, opt)


def _state_equal(a, b, what):
    assert sorted(a) == sorted(b), what
    for k in a:
        if isinstance(a[k], dict):
            _state_equal(a[k], b[k], f"{what}/{k}")
        else:
            x = a[k].detach().numpy() if isinstance(a[k], torch.Tensor) \
                else np.asarray(a[k])
            y = b[k].detach().numpy() if isinstance(b[k], torch.Tensor) \
                else np.asarray(b[k])
            np.testing.assert_array_equal(x, y, err_msg=f"{what}/{k}")


# ------------------------------------------------- kill at step, resume --

def _start_trainer(work, steps, fault=None):
    env = dict(os.environ)
    env.pop("PADDLE_MASTER", None)
    env.pop("FLAGS_fault_inject", None)
    if fault:
        env["FLAGS_fault_inject"] = fault
    return subprocess.Popen(
        [sys.executable, TRAINER, "--work", str(work), "--steps", str(steps),
         "--save-interval", "2", "--preset", "gpt2-tiny", "--seq-len", "32",
         "--vocab", str(VOCAB), "--device", "cpu"], env=env,
        stderr=subprocess.PIPE, text=True)


def _finish_trainer(p, work, expect_rc=0):
    from proc_utils import proc_timeout

    _, err = p.communicate(timeout=proc_timeout(120))
    assert p.returncode == expect_rc, (p.returncode, err[-2000:])
    with open(os.path.join(work, "events.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def test_kill_at_step_resume_bitwise(tmp_path):
    os.makedirs(tmp_path / "a")
    os.makedirs(tmp_path / "b")
    a = _start_trainer(tmp_path / "a", 8)
    b = _start_trainer(tmp_path / "b", 8, fault="kill_at_step:step=5")
    want = _finish_trainer(a, tmp_path / "a")
    _finish_trainer(b, tmp_path / "b", expect_rc=137)
    base = str(tmp_path / "b" / "ckpt")
    newest = ckpt.latest_step(base)
    assert newest == 3  # saves at 1 and 3; the kill came before 5's
    with open(os.path.join(base, f"ckpt-{newest:08d}",
                           "data-rank00000.pkl"), "r+b") as f:
        f.truncate(11)  # torn: the resume falls back to checkpoint 1
    got = _finish_trainer(_start_trainer(tmp_path / "b", 8), tmp_path / "b")
    starts = [e for e in got if e["ev"] == "start"]
    assert [e["step"] for e in starts] == [0, 2]
    finals = [e for e in (want, got) for e in e if e["ev"] == "final"]
    assert finals[0]["digest"] == finals[1]["digest"]
    losses = {e["step"]: e["loss_bits"] for e in want if e["ev"] == "step"}
    assert all(e["loss_bits"] == losses[e["step"]] for e in got
               if e["ev"] == "step")


# --------------------------------------------------- 4 -> 3 -> 4 soak ----

def test_resize_soak_4_3_4_bitwise_and_graph_kept(tmp_path):
    steps = 18
    d = str(tmp_path / "elastic")
    net, opt, train = _port_trainer()
    phases = [(4, 0, 6), (3, 6, 12), (4, 12, steps)]
    c0 = registry.counters("jit")["train_step_captures"]
    for idx, (world, lo, hi) in enumerate(phases):
        if idx:
            opt._ensure_accumulators()
            key = train._storage_key()
            state, man = ckpt.load_resharded(d, world_size=world)
            assert man["step"] == (4 if idx == 1 else 11), man["step"]
            ckpt.restore_training_state(net, opt, state)
            # in place: the storage the card's graphs key on is unchanged
            assert train._storage_key() == key
            lo = man["step"] + 1  # replay the lost tail
        for step in range(lo, hi):
            train(*_batch(step))
            state = ckpt.capture_training_state(net, opt)
            for r in range(world):
                ckpt.save_checkpoint(d, state, step=step, rank=r,
                                     world_size=world, shard=True)
        if idx == 0:
            with open(os.path.join(d, "ckpt-00000005",
                                   "data-rank00002.pkl"), "r+b") as f:
                f.truncate(7)  # the newest checkpoint is torn
        if idx < len(phases) - 1:
            for step in range(hi, hi + 2):  # trained, then lost
                train(*_batch(step))
    assert registry.counters("jit")["train_step_captures"] == c0
    ref_net, ref_opt, ref_train = _port_trainer()
    for step in range(steps):
        ref_train(*_batch(step))
    _state_equal(ckpt.capture_training_state(ref_net, ref_opt),
                 ckpt.capture_training_state(net, opt), "state")


# -------------------------------------------------- hook, fence, faults --

def test_hook_fenced_zombie_never_writes(tmp_path, store):
    net, opt, _ = _port_trainer()
    ctx = E.ElasticTrainContext(store=store, rank=0, world=1, gen=0)
    hook = ckpt.CheckpointHook(str(tmp_path / "ck"), net, opt,
                               save_interval=1, async_save=False,
                               install_sigterm=False, elastic=ctx)
    assert hook.on_step_end(0) == "saved"
    E.bump_world_epoch(store)  # the world resized past this rank
    assert hook.on_step_end(1) == "fenced"
    hook.request_preempt()
    assert hook.on_step_end(2) == "fenced"  # the emergency path too
    assert ckpt.list_steps(str(tmp_path / "ck")) == [0]


def test_rank_preempt_fault_lands_emergency_ckpt(tmp_path):
    net, opt, _ = _port_trainer()
    hook = ckpt.CheckpointHook(str(tmp_path), net, opt, save_interval=100,
                               async_save=False, install_sigterm=True)
    try:
        faults.configure("rank_preempt:step=2")
        assert hook.on_step_end(0) == "ok"
        assert hook.on_step_end(1) == "ok"
        # the SIGTERM lands inside this call and the same boundary saves
        assert hook.on_step_end(2) == "preempted"
    finally:
        hook.close()
    assert registry.counters("fault")["injected.rank_preempt"] >= 1
    _, man = ckpt.load_latest(str(tmp_path))
    assert man["step"] == 2 and man["user"]["emergency"]


def test_coordinated_preemption_consistent_manifests(tmp_path, store):
    results = {}

    def run_rank(rank):
        net, opt, _ = _port_trainer()
        ctx = E.ElasticTrainContext(store=store, rank=rank, world=2, gen=0,
                                    preempt_poll=0.02)
        ctx.coordinator.start()
        hook = ckpt.CheckpointHook(str(tmp_path), net, opt,
                                   save_interval=100, async_save=False,
                                   rank=rank, world_size=2, shard=True,
                                   reshard=True, install_sigterm=False,
                                   elastic=ctx)
        statuses = []
        for step in range(6):
            if rank == 0 and step == 2:
                hook.request_preempt()  # what the SIGTERM handler does
            ctx.barrier(f"step{step}", timeout=30)
            statuses.append(hook.on_step_end(step))
            if statuses[-1] == "preempted":
                break
        ctx.stop()
        results[rank] = statuses

    threads = [threading.Thread(target=run_rank, args=(r,)) for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    # noticed at step 2: the fleet saves at step 3, every rank
    assert results[0] == results[1] == ["ok"] * 3 + ["preempted"]
    d = os.path.join(str(tmp_path), "ckpt-00000003")
    mans = []
    for name in ("MANIFEST.json", "MANIFEST-rank00001.json"):
        with open(os.path.join(d, name)) as f:
            mans.append(json.load(f))
    assert [(m["step"], m["user"]["emergency"], m["user"]["coordinated"],
             m["user"]["preempt_target"]) for m in mans] == \
        [(3, True, 2, 3)] * 2


def test_step_hang_fault_trips_the_hooks_watchdog(tmp_path):
    import io as pyio

    net, opt, _ = _port_trainer()
    sink = pyio.StringIO()
    ctx = E.ElasticTrainContext(store=None, rank=0, world=1,
                                step_deadline=0.2,
                                watchdog_escalate="report",
                                watchdog_sink=sink)
    ctx.watchdog._poll = 0.03
    ctx.start(first_step=0)
    hook = ckpt.CheckpointHook(str(tmp_path), net, opt, save_interval=100,
                               async_save=False, install_sigterm=False,
                               elastic=ctx)
    try:
        faults.configure("step_hang:step=1,secs=0.8")
        assert hook.on_step_end(0) == "ok"
        hook.on_step_end(1)  # wedged 0.8 s against a 0.2 s deadline
    finally:
        ctx.stop()
    assert ctx.watchdog.tripped
    assert "--- thread MainThread" in sink.getvalue()
    assert registry.counters("fault")["injected.step_hang"] >= 1


# ------------------------------------------------------- fit(elastic=) ---

def _fit_model():
    net = _port_gpt()
    m = hapi.Model(net)
    m.prepare(topt.SGD(learning_rate=0.1, parameters=net.parameters()),
              tgpt.GPTPretrainingCriterion())
    return m


def _fit_data():
    toks = np.random.default_rng(0).integers(0, VOCAB, (8, 33))
    return io.TensorDataset([toks[:, :-1], toks[:, 1:]])


class _At(Callback):
    def __init__(self, batch, fn):
        self.batch, self.fn, self.seen = batch, fn, []

    def on_train_batch_end(self, step, logs=None):
        self.seen.append(step)
        if step == self.batch:
            self.fn()


def test_fit_elastic_stops_when_fenced(tmp_path, store):
    m = _fit_model()
    ctx = E.ElasticTrainContext(store=store, rank=0, world=1, gen=0)
    cb = _At(2, lambda: E.bump_world_epoch(store))
    hist = m.fit(_fit_data(), batch_size=1, epochs=3, shuffle=False,
                 verbose=0, save_dir=str(tmp_path), callbacks=[cb],
                 elastic=ctx)
    assert cb.seen == [0, 1, 2] and len(hist) == 1
    assert os.listdir(str(tmp_path)) == []  # a zombie writes nothing


def test_fit_elastic_takes_a_peers_preemption(tmp_path, store):
    m = _fit_model()
    ctx = E.ElasticTrainContext(store=store, rank=0, world=2, gen=0,
                                preempt_poll=0.01).start()
    peer = E.PreemptionCoordinator(store, 1, 2, gen=0)

    def announce():
        peer.announce(5)
        deadline = time.time() + 10
        while not ctx.preempt_requested and time.time() < deadline:
            time.sleep(0.01)

    cb = _At(1, announce)
    try:
        m.fit(_fit_data(), batch_size=1, epochs=3, shuffle=False, verbose=0,
              save_dir=str(tmp_path), callbacks=[cb], elastic=ctx)
    finally:
        ctx.stop()
    assert cb.seen == [0, 1]  # the peer's notice stopped this rank
    with open(os.path.join(str(tmp_path), "0.pdmeta")) as f:
        assert json.load(f)["emergency"]


def test_fit_elastic_emergency_checkpoint_needs_the_fence(tmp_path):
    class Ctx:  # the fence fails only at the emergency checkpoint
        preempt_requested = False

        def __init__(self):
            self.fences = []

        def step_boundary(self, step):
            pass

        def fence_check(self, what=""):
            self.fences.append(what)
            return what != "emergency ckpt"

    for fence, want in ((False, []), (True, ["0.pdmeta"])):
        d = tmp_path / str(fence)
        d.mkdir()
        m = _fit_model()
        ctx = Ctx()
        if fence:
            ctx.fence_check = lambda what="": True
        cb = _At(1, lambda: os.kill(os.getpid(), signal.SIGTERM))
        m.fit(_fit_data(), batch_size=1, epochs=2, shuffle=False,
              verbose=0, save_dir=str(d), callbacks=[cb], elastic=ctx)
        assert cb.seen == [0, 1]
        assert [n for n in os.listdir(str(d)) if n.endswith(".pdmeta")] \
            == want
        if not fence:
            assert ctx.fences == ["train loop", "train loop",
                                  "emergency ckpt"]


# ---------------------------------------- one checkpoint, both packages --

def _ref_trainer(jm):
    jopt = paddle.optimizer.AdamW(learning_rate=LR,
                                  parameters=jm.parameters())
    crit = jgpt.GPTPretrainingCriterion()

    def step(s):
        toks, labels = _batch(s)
        loss = crit(jm(paddle.to_tensor(toks)), paddle.to_tensor(labels))
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        return float(loss)

    return jopt, step


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_sharded_checkpoint_resumes_across_packages(tmp_path, writer):
    jm = _ref_gpt()
    jopt, jstep = _ref_trainer(jm)
    net, opt, train = _port_trainer(jm)
    jstep(0)
    train(*_batch(0))
    d = str(tmp_path)
    if writer == "port":
        state = ckpt.capture_training_state(net, opt)
        for r in range(2):
            ckpt.save_checkpoint(d, state, step=0, rank=r, world_size=2,
                                 shard=True)
        got, man = jckpt.load_resharded(d, world_size=1)
        fresh = _ref_gpt(seed=5)
        fopt = paddle.optimizer.AdamW(learning_rate=LR,
                                      parameters=fresh.parameters())
        jckpt.restore_training_state(fresh, fopt, got)
        want = ckpt.capture_training_state(net, opt)
        back = {"model": _np_state(fresh), "optimizer": {
            k: (np.asarray(v.numpy()) if hasattr(v, "numpy") else v)
            for k, v in fopt.state_dict().items()}}
    else:
        state = jckpt.capture_training_state(jm, jopt)
        for r in range(2):
            jckpt.save_checkpoint(d, state, step=0, rank=r, world_size=2,
                                  shard=True)
        got, man = ckpt.load_resharded(d, world_size=1)
        fresh, fopt, _ = _port_trainer(_ref_gpt(seed=5))
        ckpt.restore_training_state(fresh, fopt, got)
        back = ckpt.capture_training_state(fresh, fopt)
        want = {"model": _np_state(jm), "optimizer": {
            k: (np.asarray(v.numpy()) if hasattr(v, "numpy") else v)
            for k, v in jopt.state_dict().items()}}
    assert man["world_size"] == 2 and man["sharded"]
    for part in ("model", "optimizer"):
        a, b = want[part], back[part]
        keys = [k for k in a if k != "LR_Scheduler"]
        for k in keys:
            x = a[k].detach().float().numpy() \
                if isinstance(a[k], torch.Tensor) else np.asarray(a[k])
            y = b[k].detach().float().numpy() \
                if isinstance(b[k], torch.Tensor) else np.asarray(b[k])
            np.testing.assert_array_equal(x, y, err_msg=f"{part}/{k}")


def test_elastic_leg_losses_match_the_reference(tmp_path):
    jm = _ref_gpt()
    jopt, jstep = _ref_trainer(jm)
    want = [jstep(s) for s in range(8)]
    net, opt, train = _port_trainer(_ref_gpt())
    s = TCPStore("127.0.0.1", 0, is_master=True, world_size=1)
    ref = JStore("127.0.0.1", s.port, is_master=False, world_size=1)
    ctx = E.ElasticTrainContext(store=s, rank=0, world=1, gen=0).start()
    hook = ckpt.CheckpointHook(str(tmp_path), net, opt, save_interval=3,
                               async_save=False, install_sigterm=False,
                               reshard=True, elastic=ctx)
    got = {}
    step, restored = 0, False
    try:
        while step < 8:
            got[step] = float(train(*_batch(step)).detach())
            assert hook.on_step_end(step) in ("ok", "saved")
            if step == 4 and not restored:
                restored = True
                # a sibling restarted: resume from checkpoint 2 in place,
                # as the reference's watcher sees the generation move
                JE.publish_generation(ref, 2)
                step = hook.restore()
                assert step == 3
                continue
            step += 1
    finally:
        ctx.stop()
    assert int(s.add("elastic/gen", 0)) == 1
    np.testing.assert_allclose([got[i] for i in range(8)], want, **TOL)
