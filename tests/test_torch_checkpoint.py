"""The port's checkpoint engine (``framework`` save/load,
``incubate.checkpoint``) and the checkpoint follower, against the JAX
package's, both ways: a checkpoint written by either package loads in the
other, unsharded and sharded at world size 2, bf16 leaves included.

Models: ``gpt2-tiny`` (vocab 96) with AdamW state after one real step on
each side. Arrays are compared exactly: the format moves bytes, and bf16
is widened to float32 on the way, which is exact.
"""
import os
import pickle

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import framework as jframework  # noqa: E402
from paddle_tpu.incubate import checkpoint as jckpt  # noqa: E402
from paddle_tpu.models import gpt as jgpt  # noqa: E402
from paddle_tpu_torch import convert, framework  # noqa: E402
from paddle_tpu_torch.incubate import checkpoint as ckpt  # noqa: E402
from paddle_tpu_torch.models import gpt as tgpt  # noqa: E402
from paddle_tpu_torch.optimizer import AdamW  # noqa: E402
from paddle_tpu_torch.optimizer.lr import CosineAnnealingDecay  # noqa: E402
from paddle_tpu_torch.profiler import explainer, registry  # noqa: E402
from paddle_tpu_torch.serving import (CheckpointFollower,  # noqa: E402
                                      GenerationEngine, GenerationServer)

# one intra-op thread: the suite's parallel workers share the CPU, and
# a torch thread pool in each would oversubscribe it
torch.set_num_threads(1)

VOCAB = 96
EKW = dict(max_batch_size=2, buckets=(16, 32), rng_seed=9, block_size=8)
PROMPT = [5, 9, 2, 7, 1, 3, 8, 8, 4]


@pytest.fixture(autouse=True)
def _keep_torch_rng():
    # restores and the hook's resume set torch's default generator
    state = torch.get_rng_state()
    yield
    torch.set_rng_state(state)


def _jax_trained(seed, dtype="float32"):
    """A reference gpt2-tiny and its AdamW after one step. The global
    generator is put back after: later tests in this process draw what
    they would have drawn without this file."""
    rng_state = paddle.get_rng_state()
    try:
        paddle.seed(seed)
        cfg = jgpt.GPTConfig.preset("gpt2-tiny", vocab_size=VOCAB,
                                    initializer_range=0.35, dtype=dtype)
        jm = jgpt.GPTForPretraining(jgpt.GPTModel(cfg))
        opt = paddle.optimizer.AdamW(learning_rate=1e-2,
                                     parameters=jm.parameters(),
                                     multi_precision=dtype != "float32")
        toks = np.random.default_rng(seed).integers(0, VOCAB, (2, 16))
        loss = jgpt.GPTPretrainingCriterion()(
            jm(paddle.to_tensor(toks)),
            paddle.to_tensor(np.roll(toks, -1, 1)))
        loss.backward()
        opt.step()
        opt.clear_grad()
    finally:
        paddle.set_rng_state(rng_state)
    return jm, opt


def _port_model(seed=0, dtype="float32", dropout=0.0):
    cfg = tgpt.GPTConfig.preset("gpt2-tiny", vocab_size=VOCAB,
                                initializer_range=0.35, dtype=dtype,
                                dropout=dropout)
    return tgpt.GPTForPretraining(tgpt.GPTModel(
        cfg, device="cpu", generator=torch.Generator().manual_seed(seed)))


def _port_step(model, opt, step):
    toks = np.random.default_rng(100 + step).integers(0, VOCAB, (2, 16))
    loss = tgpt.GPTPretrainingCriterion()(
        model(torch.from_numpy(toks)),
        torch.from_numpy(np.roll(toks, -1, 1)))
    loss.backward()
    opt.step()
    opt.clear_grad()
    return loss.detach()


def _np(v):
    """A reference Tensor, a torch tensor or an array as float32 numpy."""
    if isinstance(v, torch.Tensor):
        return v.detach().float().numpy()
    a = np.asarray(v.numpy() if hasattr(v, "numpy") else v)
    return a.astype(np.float32)


def _equal_nests(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], (int, float, dict)):
            assert got[k] == want[k], k
        else:
            assert np.array_equal(_np(got[k]), _np(want[k])), k


def test_framework_round_trip_and_reference_reads_it(tmp_path):
    g = torch.Generator().manual_seed(0)
    w = torch.nn.Parameter(torch.randn(3, 4, generator=g))
    b16 = torch.randn(5, generator=g).bfloat16()
    obj = {"w": w, "nest": [b16, 3, "x"], "t": (np.arange(4), {"s": 2.5})}
    path = str(tmp_path / "state.pkl")
    framework.save(obj, path)
    got = framework.load(path)
    assert np.array_equal(got["w"], w.detach().numpy())
    assert got["nest"][0].dtype == np.float32
    assert np.array_equal(got["nest"][0], b16.float().numpy())
    assert got["nest"][1:] == [3, "x"] and isinstance(got["t"], tuple)
    assert np.array_equal(got["t"][0], np.arange(4))
    assert got["t"][1] == {"s": 2.5}
    # the reference reads it: records become its Tensors
    ref = jframework.load(path)
    assert np.array_equal(np.asarray(ref["w"].numpy()), got["w"])
    assert np.array_equal(np.asarray(ref["nest"][0].numpy()),
                          got["nest"][0])
    # and the port reads the reference's own files
    jframework.save({"a": paddle.to_tensor(np.ones((2, 2), np.float32))},
                    path)
    assert np.array_equal(framework.load(path)["a"], np.ones((2, 2)))
    # a snapshot: saving a CPU tensor copies it
    state = framework._to_saveable({"w": w})
    with torch.no_grad():
        w.add_(1)
    assert not np.array_equal(state["w"]["data"], w.detach().numpy())


@pytest.mark.parametrize("world,dtype", [(1, "float32"), (2, "float32"),
                                         (1, "bfloat16")],
                         ids=["unsharded", "sharded_world2", "bf16"])
def test_reference_checkpoint_loads_in_port(tmp_path, world, dtype):
    jm, jopt = _jax_trained(3, dtype)
    state = jckpt.capture_training_state(jm, jopt)
    for rank in range(world):
        jckpt.save_checkpoint(str(tmp_path), state, 7, rank=rank,
                              world_size=world, shard=world > 1)
    if world > 1:
        with pytest.raises(ckpt.WorldSizeMismatchError):
            ckpt.load_latest(str(tmp_path), world_size=1)
    got, man = ckpt.load_resharded(str(tmp_path))
    assert man["step"] == 7 and man["world_size"] == world
    assert ckpt.latest_step(str(tmp_path)) == 7
    _equal_nests(got["model"], jm.state_dict())
    _equal_nests(got["optimizer"], jopt.state_dict())
    # restored into a port model and optimizer, in place
    tm = _port_model(1, dtype)
    topt = AdamW(learning_rate=1e-2, parameters=tm.parameters(),
                 multi_precision=dtype != "float32")
    ids = [id(p) for p in tm.parameters()]
    ckpt.restore_training_state(tm, topt, got)
    assert [id(p) for p in tm.parameters()] == ids
    _equal_nests(convert.state_to_paddle_tpu(tm), jm.state_dict())
    _equal_nests(convert.optimizer_state_to_paddle_tpu(topt, tm),
                 jopt.state_dict())
    if world == 1:
        # the hook resumes from it; the reference's threefry key is left
        # alone, and says so
        hook = ckpt.CheckpointHook(str(tmp_path), _port_model(2, dtype),
                                   install_sigterm=False)
        n = len(explainer.events(kind="checkpoint_rng_skipped"))
        assert hook.restore() == 8
        assert len(explainer.events(kind="checkpoint_rng_skipped")) == n + 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_loads_in_reference(tmp_path, dtype):
    tm = _port_model(4, dtype)
    topt = AdamW(learning_rate=1e-2, parameters=tm.parameters(),
                 multi_precision=dtype != "float32")
    _port_step(tm, topt, 0)
    ckpt.save_checkpoint(str(tmp_path), ckpt.capture_training_state(
        tm, topt), 5)
    jm, jopt = _jax_trained(3, dtype)
    jopt._ensure_accumulators()
    state, man = jckpt.load_latest(str(tmp_path), world_size=1)
    assert man["step"] == 5 and man["rng"] is None
    jckpt.restore_training_state(jm, jopt, state)
    _equal_nests(jm.state_dict(), convert.state_to_paddle_tpu(tm))
    _equal_nests(jopt.state_dict(),
                 convert.optimizer_state_to_paddle_tpu(topt, tm))


def test_hook_resumes_from_a_sharded_reference_checkpoint(tmp_path):
    jm, jopt = _jax_trained(4)
    state = jckpt.capture_training_state(jm, jopt)
    for rank in range(2):
        jckpt.save_checkpoint(str(tmp_path), state, 5, rank=rank,
                              world_size=2, shard=True)
    tm = _port_model(1)
    topt = AdamW(learning_rate=1e-2, parameters=tm.parameters())
    raw = ckpt.CheckpointHook(str(tmp_path), tm, topt, install_sigterm=False)
    with pytest.raises(ckpt.WorldSizeMismatchError):
        raw.restore()
    hook = ckpt.CheckpointHook(str(tmp_path), tm, topt, reshard=True,
                               install_sigterm=False)
    assert hook.restore() == 6
    _equal_nests(convert.state_to_paddle_tpu(tm), jm.state_dict())
    _equal_nests(convert.optimizer_state_to_paddle_tpu(topt, tm),
                 jopt.state_dict())


def test_torn_payload_is_skipped(tmp_path):
    base = str(tmp_path)
    for step in (1, 2):
        ckpt.save_checkpoint(base, {"x": torch.full((64,), float(step))},
                             step)
    payload = os.path.join(base, "ckpt-00000002", "data-rank00000.pkl")
    with open(payload, "r+b") as f:
        f.truncate(os.path.getsize(payload) // 2)
    c0 = registry.counters("checkpoint")["skipped_corrupt"]
    assert ckpt.latest_step(base) == 1
    state, man = ckpt.load_latest(base)
    assert man["step"] == 1 and np.all(state["x"] == 1.0)
    assert registry.counters("checkpoint")["skipped_corrupt"] == c0 + 1
    # the reference agrees
    assert jckpt.latest_step(base) == 1


def test_async_saves_and_pruning(tmp_path):
    base = str(tmp_path)
    mgr = ckpt.CheckpointManager(base, max_to_keep=2)
    x = torch.zeros(16)
    for step in range(5):
        x.fill_(step)
        mgr.save({"x": x}, step)  # a snapshot: later writes don't leak in
    mgr.wait()
    assert ckpt.list_steps(base) == [3, 4]
    state, man = ckpt.load_latest(base)
    assert man["step"] == 4 and np.all(state["x"] == 4.0)
    assert np.all(ckpt.load_resharded(base, step=3)[0]["x"] == 3.0)


def test_checkpoint_hook_resume_is_bitwise(tmp_path):
    def run(steps, start_model=0, restore=False, crash_after=None):
        torch.manual_seed(0)
        model = _port_model(start_model, dropout=0.1)
        sched = CosineAnnealingDecay(1e-2, T_max=10)
        opt = AdamW(learning_rate=sched, parameters=model.parameters())
        hook = ckpt.CheckpointHook(str(tmp_path), model, opt,
                                   save_interval=3, install_sigterm=False)
        start = hook.restore() if restore else 0
        losses = {}
        for step in range(start, steps):
            losses[step] = _port_step(model, opt, step)
            sched.step()
            hook.on_step_end(step)
            if step == crash_after:
                break
        hook.close()
        return start, losses

    _, want = run(6)
    for d in tmp_path.iterdir():
        __import__("shutil").rmtree(d)
    run(6, crash_after=2)  # saves at step 2, then dies
    start, got = run(6, start_model=5, restore=True)
    assert start == 3
    assert all(torch.equal(got[s], want[s]) for s in range(3, 6))
    # the elastic context is accepted and wired: one step boundary ticks
    # it once and runs the fence once before the periodic save
    spy = _ElasticSpy()
    hook = ckpt.CheckpointHook(str(tmp_path / "elastic"), _port_model(),
                               save_interval=1, install_sigterm=False,
                               elastic=spy)
    assert hook.on_step_end(0) == "saved"
    assert spy.ticks == [0] and spy.fences == ["periodic save"]
    hook.close()


class _ElasticSpy:
    """Duck-types ``ElasticTrainContext`` and records what it is asked."""

    coordinator = None
    preempt_requested = False

    def __init__(self):
        self.ticks, self.fences = [], []

    def step_boundary(self, step):
        self.ticks.append(step)

    def fence_check(self, what=""):
        self.fences.append(what)
        return True


def test_emergency_save_on_preempt(tmp_path):
    model = _port_model()
    hook = ckpt.CheckpointHook(str(tmp_path), model, save_interval=100,
                               install_sigterm=False)
    assert hook.on_step_end(0) == "ok"
    hook.request_preempt()
    assert hook.on_step_end(1) == "preempted"
    state, man = ckpt.load_latest(str(tmp_path))
    assert man["step"] == 1 and man["user"] == {"emergency": True}
    _equal_nests(state["model"], convert.state_to_paddle_tpu(model))


class _CountingPickle:
    """Stands in for the checkpoint module's ``pickle``: counts loads."""

    def __init__(self):
        self.loads_calls = 0

    def loads(self, blob):
        self.loads_calls += 1
        return pickle.loads(blob)

    def dumps(self, *args, **kw):
        return pickle.dumps(*args, **kw)


def _tokens(engine, prompt=PROMPT, n=6):
    out = [engine.prefill(0, prompt, seed=0)]
    while len(out) < n:
        out.append(int(engine.decode_step()[0]))
    engine.release(0)
    return out


def _jax_state(seed):
    jm, _ = _jax_trained(seed)
    return jm, {"model": jm.state_dict()}


def _fresh_tokens(jm):
    tm = _port_model()
    convert.load_paddle_tpu_state(tm, {k: np.asarray(v.numpy()) for k, v in
                                       jm.state_dict().items()})
    return _tokens(GenerationEngine(tm, device="cpu", **EKW))


def test_follower_tracks_reference_checkpoints(tmp_path, monkeypatch):
    base = str(tmp_path)
    counting = _CountingPickle()
    monkeypatch.setattr(ckpt, "pickle", counting)
    srv = GenerationServer(engine=GenerationEngine(_port_model(), device="cpu",
                                                   **EKW))
    srv.start()
    try:
        follower = CheckpointFollower(srv, base)
        jm1, st1 = _jax_state(11)
        jckpt.save_checkpoint(base, st1, 1)
        assert follower.poll() == 1 and srv.last_swap_step == 1
        assert counting.loads_calls == 1
        for _ in range(3):  # no news: nothing is read again
            assert follower.poll() is None
        assert counting.loads_calls == 1
        want1 = _fresh_tokens(jm1)
        assert srv.generate(PROMPT, max_new_tokens=6, seed=0) == want1

        # a torn newer checkpoint is skipped, unread
        jckpt.save_checkpoint(base, _jax_state(12)[1], 2)
        payload = os.path.join(base, "ckpt-00000002", "data-rank00000.pkl")
        with open(payload, "r+b") as f:
            f.truncate(100)
        assert follower.poll() is None and srv.last_swap_step == 1
        assert counting.loads_calls == 1

        # a sharded one merges: one load per shard, once
        jm3, st3 = _jax_state(13)
        for rank in range(2):
            jckpt.save_checkpoint(base, st3, 3, rank=rank, world_size=2,
                                  shard=True)
        assert follower.poll() == 3 and counting.loads_calls == 3
        assert follower.poll() is None and counting.loads_calls == 3
        assert srv.generate(PROMPT, max_new_tokens=6, seed=0) == \
            _fresh_tokens(jm3)

        # a refused swap does not advance last_swap_step, and the same
        # file set is not read again
        bad = {"model": {k: np.asarray(v.numpy()) for k, v in
                         jm1.state_dict().items()}}
        name = next(k for k, v in bad["model"].items() if v.ndim == 2)
        bad["model"][name] = bad["model"][name][:-1]
        c0 = registry.counters("serving")["swap_failures"]
        jckpt.save_checkpoint(base, bad, 4)
        assert follower.poll() is None and srv.last_swap_step == 3
        assert registry.counters("serving")["swap_failures"] == c0 + 1
        assert follower.poll() is None and counting.loads_calls == 4
        assert srv.generate(PROMPT, max_new_tokens=6, seed=0) == \
            _fresh_tokens(jm3)
    finally:
        srv.shutdown(timeout=60)


@pytest.mark.parametrize("world", [1, 2])
def test_follower_reads_each_payload_once(tmp_path, monkeypatch, world):
    """One attempt reads and checksums each payload of the checkpoint it
    swaps in once, and nothing of the one it already serves."""
    base = str(tmp_path)
    reads = []
    verified = ckpt._verified_blob

    def counting(b, step, rank):
        reads.append((step, rank))
        return verified(b, step, rank)

    monkeypatch.setattr(ckpt, "_verified_blob", counting)
    srv = GenerationServer(engine=GenerationEngine(_port_model(), device="cpu",
                                                   **EKW))
    srv.start()
    try:
        follower = CheckpointFollower(srv, base)
        jckpt.save_checkpoint(base, _jax_state(11)[1], 1)
        assert follower.poll() == 1 and reads == [(1, 0)]
        jm2, st2 = _jax_state(12)
        for rank in range(world):
            jckpt.save_checkpoint(base, st2, 2, rank=rank, world_size=world,
                                  shard=world > 1)
        assert follower.poll() == 2
        assert reads[1:] == [(2, r) for r in range(world)]
        assert follower.poll() is None and len(reads) == 1 + world
        assert srv.generate(PROMPT, max_new_tokens=6, seed=0) == \
            _fresh_tokens(jm2)
    finally:
        srv.shutdown(timeout=60)


def test_watch_checkpoints_follows_a_port_training_run(tmp_path):
    base = str(tmp_path)
    srv = GenerationServer(engine=GenerationEngine(_port_model(), device="cpu",
                                                   **EKW))
    srv.start()
    try:
        srv.watch_checkpoints(base, interval=0.02)
        trained = _port_model(8)
        opt = AdamW(learning_rate=1e-2, parameters=trained.parameters())
        for step in range(2):
            _port_step(trained, opt, step)
        ckpt.save_checkpoint(base, ckpt.capture_training_state(trained, opt),
                             1)
        for _ in range(3000):
            if srv.last_swap_step == 1:
                break
            __import__("time").sleep(0.01)
        assert srv.last_swap_step == 1
        want = _tokens(GenerationEngine(trained, device="cpu", **EKW))
        assert srv.generate(PROMPT, max_new_tokens=6, seed=0) == want
    finally:
        srv.shutdown(timeout=60)
    assert srv._watcher is None
