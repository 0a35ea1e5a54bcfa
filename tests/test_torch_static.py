"""The port's static mode (``paddle_tpu_torch.static``: Program, the
recorder, the Executor, ``static.nn``) against ``paddle_tpu.static`` on the
CPU: the same Program built in both packages, the same numpy feeds, the
reference's parameters carried across by
``convert.static_scope_from_paddle_tpu`` (by position in
``program.params``).

Tolerance: every float32 comparison with the reference is held to 1e-5
relative, 1e-6 absolute for values near 0 (``TOL``). The largest gaps
measured on the CPU: ERNIE's pooled output (``ernie_tiny`` at vocab 128,
64 positions, seq 16, values up to 1) 1.2e-6 absolute, within 1e-6 plus
1.4e-6 relative; the MLP's parameters after 25 Adam runs 3.6e-7 absolute.

Both packages keep their static state process-wide: every test that
enters static mode leaves it in a fixture or a ``finally``, under a fresh
Program and ``scope_guard(Scope())`` in each package.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.models import ernie as jernie  # noqa: E402
import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch import convert, static  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch.models import ernie as ternie  # noqa: E402
from paddle_tpu_torch.nn import functional as TF  # noqa: E402
from paddle_tpu_torch.nn.layer.transformer import \
    MultiHeadAttention  # noqa: E402
from paddle_tpu_torch.ops import flash_attention as fa  # noqa: E402

# one intra-op thread: the suite's parallel workers share the CPU
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture
def both():
    """Both packages in static mode, each under a fresh scope."""
    paddle.enable_static()
    pt.enable_static()
    try:
        with paddle.static.scope_guard(paddle.static.Scope()), \
                static.scope_guard(static.Scope()):
            yield
    finally:
        pt.disable_static()
        paddle.disable_static()


def _exes():
    return paddle.static.Executor(), static.Executor("cpu")


def _carry(jprog, tprog):
    """The reference Program's initial parameters into the port's scope."""
    ref_vars = {v.name: np.asarray(a) for v, a in jprog.params}
    convert.static_scope_from_paddle_tpu(ref_vars, jprog, tprog)


def _rng_x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_program_record_and_run(both):
    jprog, tprog = paddle.static.Program(), static.Program()
    with paddle.static.program_guard(jprog):
        x = paddle.static.data("x", [None, 4], "float32")
        jy = x * 2.0 + 1.0
    with static.program_guard(tprog):
        x = static.data("x", [None, 4], "float32")
        ty = x * 2.0 + 1.0
    jexe, texe = _exes()
    xs = _rng_x((3, 4))
    want, = jexe.run(jprog, feed={"x": xs}, fetch_list=[jy])
    got, = texe.run(tprog, feed={"x": xs}, fetch_list=[ty])
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, xs * 2 + 1, rtol=1e-6)


def _mlp(pkg):
    x = pkg.static.data("x", [None, 8], "float32")
    t = pkg.static.data("t", [None, 1], "float32")
    h = pkg.static.nn.fc(x, 16, activation="relu")
    pred = pkg.static.nn.fc(h, 1)
    return x, t, pred


def test_static_training_matches_reference_step_by_step(both):
    """Adam(0.05) on an MLP, 25 runs: the port's losses are the
    reference's, run by run."""
    jprog, tprog = paddle.static.Program(), static.Program()
    with paddle.static.program_guard(jprog):
        _, _, pred = _mlp(paddle)
        t = jprog.feed_vars["t"]
        jloss = paddle.nn.functional.mse_loss(pred, t)
        paddle.optimizer.Adam(0.05).minimize(jloss)
    with static.program_guard(tprog):
        _, _, pred = _mlp(pt)
        tloss = TF.mse_loss(pred, tprog.feed_vars["t"])
        topt.Adam(0.05).minimize(tloss)
    _carry(jprog, tprog)
    jexe, texe = _exes()
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((32, 8)).astype(np.float32)
    ts = (xs.sum(1, keepdims=True) * 0.3).astype(np.float32)
    feed = {"x": xs, "t": ts}
    want = [float(jexe.run(jprog, feed=feed, fetch_list=[jloss])[0])
            for _ in range(25)]
    got = [float(texe.run(tprog, feed=feed, fetch_list=[tloss])[0])
           for _ in range(25)]
    np.testing.assert_allclose(got, want, **TOL)
    assert got[-1] < got[0] * 0.2
    # the trained parameters, carried back by position
    back = convert.static_scope_to_paddle_tpu(tprog, jprog)
    ref_scope = paddle.static.global_scope().vars
    for name, value in back.items():
        np.testing.assert_allclose(value, np.asarray(ref_scope[name]),
                                   err_msg=name, **TOL)


def test_feed_shape_specialization(both):
    jprog, tprog = paddle.static.Program(), static.Program()
    with paddle.static.program_guard(jprog):
        x = paddle.static.data("x", [None, 3], "float32")
        jy = paddle.sum(x, axis=1)
    with static.program_guard(tprog):
        x = static.data("x", [None, 3], "float32")
        ty = torch.sum(x, 1)
    jexe, texe = _exes()
    for bs in (2, 5):
        xs = _rng_x((bs, 3), bs)
        got, = texe.run(tprog, feed={"x": xs}, fetch_list=[ty])
        want, = jexe.run(jprog, feed={"x": xs}, fetch_list=[jy])
        assert got.shape == (bs,)
        np.testing.assert_allclose(got, want, **TOL)


def test_dynamic_batch_stays_symbolic_through_reshape(both):
    """``x.shape[0]`` fed to ``reshape`` / ``view`` is read when the
    Program runs: one record runs at batch 2 and at batch 5."""
    tprog = static.Program()
    with static.program_guard(tprog):
        x = static.data("x", [None, 6], "float32")
        B = x.shape[0]
        assert isinstance(B, static.program.SymDim)
        y = x.reshape(B, 2, 3).sum(-1)
        z = y.view(B * 2)
        n = torch.zeros(B, device=x.device) + 1.0
    texe = static.Executor("cpu")
    for bs in (2, 5):
        xs = _rng_x((bs, 6), bs)
        got_y, got_z, got_n = texe.run(tprog, feed={"x": xs},
                                       fetch_list=[y, z, n])
        np.testing.assert_allclose(got_y, xs.reshape(bs, 2, 3).sum(-1),
                                   **TOL)
        np.testing.assert_allclose(got_z, got_y.reshape(bs * 2))
        np.testing.assert_array_equal(got_n, np.ones(bs, np.float32))


def test_program_clone_for_test(both):
    tprog = static.Program()
    with static.program_guard(tprog):
        x = static.data("x", [None, 2], "float32")
        y = x.exp()
        topt.SGD(0.1).minimize(torch.sum(y))
    test_prog = tprog.clone(for_test=True)
    assert not test_prog.minimize_reqs and tprog.minimize_reqs
    assert len(test_prog.ops) == len(tprog.ops)
    xs = _rng_x((3, 2))
    got, = static.Executor("cpu").run(test_prog, feed={"x": xs},
                                      fetch_list=[y])
    np.testing.assert_allclose(got, np.exp(xs), **TOL)


def _ernie_pair():
    state = paddle.get_rng_state()
    try:
        paddle.seed(0)
        jm = jernie.ernie_tiny(vocab_size=128, max_position_embeddings=64)
    finally:
        paddle.set_rng_state(state)
    tm = ternie.ernie_tiny(vocab_size=128, max_position_embeddings=64,
                           device="cpu")
    convert.load_paddle_tpu_state(
        tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    return jm, tm


def test_ernie_static_inference_matches_reference():
    """The reference's test_ernie_static_inference: the pooled output of
    ``build_static_inference_program`` through each Executor, at two
    batch sizes from one record of the port."""
    jm, tm = _ernie_pair()
    jprog, _, jfetch = jernie.build_static_inference_program(jm, seq_len=16)
    assert pt.in_dynamic_mode()
    tprog, feeds, tfetch = ternie.build_static_inference_program(
        tm, seq_len=16)
    assert pt.in_dynamic_mode() and feeds == ["input_ids"]
    with paddle.static.scope_guard(paddle.static.Scope()), \
            static.scope_guard(static.Scope()):
        jexe, texe = _exes()
        for bs in (2, 5):
            ids = np.random.default_rng(bs).integers(0, 128, (bs, 16))
            want, = jexe.run(jprog, feed={"input_ids": ids},
                             fetch_list=[jfetch])
            got, = texe.run(tprog, feed={"input_ids": ids},
                            fetch_list=[tfetch])
            assert got.shape == (bs, 128)
            np.testing.assert_allclose(got, want, **TOL)
            with torch.no_grad():
                eager = tm(torch.from_numpy(ids))[1].numpy()
            np.testing.assert_array_equal(got, eager)


def test_while_loop_counter_model(both):
    def build(pkg, zeros):
        x = pkg.static.data("x", [None, 4], "float32")
        limit = pkg.static.data("limit", [1], "float32")

        def cond_fn(i, acc):
            return i < limit

        def body_fn(i, acc):
            return [i + 1.0, acc + x.sum()]

        return pkg.static.nn.while_loop(cond_fn, body_fn,
                                        [zeros(), zeros()])

    jprog, tprog = paddle.static.Program(), static.Program()
    with paddle.static.program_guard(jprog):
        jout = build(paddle, lambda: paddle.zeros([1], "float32"))
    with static.program_guard(tprog):
        tout = build(pt, lambda: torch.zeros(1))
    jexe, texe = _exes()
    feed = {"x": _rng_x((2, 4)), "limit": np.array([5.0], np.float32)}
    want = jexe.run(jprog, feed=feed, fetch_list=list(jout))
    got = texe.run(tprog, feed=feed, fetch_list=list(tout))
    assert float(got[0][0]) == 5.0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


def test_cond_with_closure(both):
    jprog, tprog = paddle.static.Program(), static.Program()
    with paddle.static.program_guard(jprog):
        jx = paddle.static.data("x", [None, 3], "float32")
        jout = paddle.static.nn.cond(jx.sum() > 0.0, lambda: jx * 2.0,
                                     lambda: jx - 10.0)
    with static.program_guard(tprog):
        tx = static.data("x", [None, 3], "float32")
        tout = static.nn.cond(tx.sum() > 0.0, lambda: tx * 2.0,
                              lambda: tx - 10.0)
    jexe, texe = _exes()
    for xs in (np.ones((2, 3), np.float32), -np.ones((4, 3), np.float32)):
        got, = texe.run(tprog, feed={"x": xs}, fetch_list=[tout])
        want, = jexe.run(jprog, feed={"x": xs}, fetch_list=[jout])
        np.testing.assert_allclose(got, want, **TOL)


def test_cond_grad_in_training(both):
    """SGD through the branch a cond takes: the reference's losses run by
    run, and they fall."""
    def build(pkg, sgd, mean):
        x = pkg.static.data("x", [None, 2], "float32")
        h = pkg.static.nn.fc(x, 4)
        out = pkg.static.nn.cond(h.sum() > 1e9, lambda: h, lambda: h * 0.5)
        loss = mean(out * out)
        sgd(0.1).minimize(loss)
        return loss

    jprog, tprog = paddle.static.Program(), static.Program()
    with paddle.static.program_guard(jprog):
        jloss = build(paddle, paddle.optimizer.SGD, lambda v: v.mean())
    with static.program_guard(tprog):
        tloss = build(pt, topt.SGD, torch.mean)
    _carry(jprog, tprog)
    jexe, texe = _exes()
    feed = {"x": _rng_x((8, 2))}
    want = [float(jexe.run(jprog, feed=feed, fetch_list=[jloss])[0])
            for _ in range(20)]
    got = [float(texe.run(tprog, feed=feed, fetch_list=[tloss])[0])
           for _ in range(20)]
    np.testing.assert_allclose(got, want, **TOL)
    assert got[-1] < got[0]


def test_python_bool_on_variable_raises(both):
    with paddle.static.program_guard(paddle.static.Program()):
        x = paddle.static.data("x", [None, 2], "float32")
        with pytest.raises(TypeError, match="cond"):
            if x.sum() > 0:
                pass
    with static.program_guard(static.Program()):
        x = static.data("x", [None, 2], "float32")
        with pytest.raises(TypeError, match="cond"):
            if x.sum() > 0:
                pass


def test_inplace_ops_alias_in_program(both):
    """``increment`` twice, then a read: later ops and fetches see the
    rebound value (the port's in-place calls: ``add_`` and ``+=``)."""
    jprog, tprog = paddle.static.Program(), static.Program()
    with paddle.static.program_guard(jprog):
        jv = paddle.static.data("v", [1], "float32")
        paddle.increment(jv)
        paddle.increment(jv)
        jw = jv + 10.0
    with static.program_guard(tprog):
        tv = static.data("v", [1], "float32")
        tv.add_(1.0)
        tv += 1.0
        tw = tv + 10.0
    jexe, texe = _exes()
    feed = {"v": np.array([2.0], np.float32)}
    want = jexe.run(jprog, feed=feed, fetch_list=[jv, jw])
    got = texe.run(tprog, feed=feed, fetch_list=[tv, tw])
    assert float(got[0][0]) == 4.0 and float(got[1][0]) == 14.0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("attr,value", [
    ("amp_o2_dtype", "bfloat16"), ("grad_merge_k", 2),
    ("sharding_degree", 2), ("localsgd_k", 4),
    ("fp16_allreduce_dtype", "float16"), ("grad_clip_norm", 1.0)])
def test_pass_attribute_raises_naming_item_11b(both, attr, value):
    tprog = static.Program()
    with static.program_guard(tprog):
        x = static.data("x", [None, 2], "float32")
        y = x * 2.0
    setattr(tprog, attr, value)
    with pytest.raises(NotImplementedError, match="11b"):
        static.Executor("cpu").run(tprog, feed={"x": _rng_x((2, 2))},
                                   fetch_list=[y])


def test_both_packages_dynamic_after_a_raise_inside_program_guard():
    modes = torch._C._len_torch_function_stack()
    with pytest.raises(ZeroDivisionError):
        paddle.enable_static()
        pt.enable_static()
        try:
            with paddle.static.program_guard(paddle.static.Program()), \
                    static.program_guard(static.Program()):
                static.data("x", [None, 2], "float32") * 2.0
                1 / 0
        finally:
            pt.disable_static()
            paddle.disable_static()
    assert pt.in_dynamic_mode() and paddle.in_dynamic_mode()
    assert torch._C._len_torch_function_stack() == modes
    y = torch.ones(2) * 2.0  # runs, not recorded
    assert type(y) is torch.Tensor and float(y.sum()) == 4.0


def test_attention_is_one_call_routed_when_the_program_runs(both):
    """A Program records ``flash_attention`` whole, so its route is
    chosen on the real tensors when it runs: with ``kernel="cuda"`` the
    record succeeds on the CPU and its run raises for want of CUDA
    tensors; on the plain route the run equals the layer's eager call."""
    torch.manual_seed(0)
    mha = MultiHeadAttention(64, 1)
    with torch.no_grad():
        xs = _rng_x((2, 8, 64))
        want = mha(torch.from_numpy(xs)).numpy()
    tprog = static.Program()
    with static.program_guard(tprog):
        x = static.data("x", [None, 8, 64], "float32")
        y = mha(x)
    calls = [op for op in tprog.ops if op.fn is fa.flash_attention]
    assert len(calls) == 1
    got, = static.Executor("cpu").run(tprog, feed={"x": xs}, fetch_list=[y])
    np.testing.assert_allclose(got, want, **TOL)
    mha.kernel = "cuda"
    cprog = static.Program()
    with static.program_guard(cprog):
        x = static.data("x", [None, 8, 64], "float32")
        y = mha(x)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        static.Executor("cpu").run(cprog, feed={"x": xs}, fetch_list=[y])


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("where", ["fake", "meta"])
def test_attention_op_fake_matches_the_real_op(kernel, where):
    B, T, N, H = 2, 128, 2, 64
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, T, N, H)).astype(
        np.float32)) for _ in range(3))
    real = fa.attention_op(q, k, v, None, False, H ** -0.5, kernel)
    if where == "meta":
        got = fa.attention_op(*(t.to("meta") for t in (q, k, v)), None,
                              False, H ** -0.5, kernel)
    else:
        from torch._subclasses.fake_tensor import FakeTensorMode

        with FakeTensorMode() as mode:
            got = fa.attention_op(*(mode.from_tensor(t) for t in (q, k, v)),
                                  None, False, H ** -0.5, kernel)
    for g, r in zip(got, real):
        assert g.shape == r.shape and g.dtype == r.dtype
    assert got[1].dtype == torch.float32 and tuple(got[1].shape) == (B, N, T)


def test_append_backward_keeps_the_gradients_in_the_scope(both):
    tprog = static.Program()
    with static.program_guard(tprog):
        x = static.data("x", [None, 3], "float32")
        loss = torch.mean(static.nn.fc(x, 2) ** 2)
        pairs = static.append_backward(loss)
    assert [p.name for p, _ in pairs] == [v.name for v in
                                          tprog.all_parameters()]
    xs = _rng_x((4, 3))
    static.Executor("cpu").run(tprog, feed={"x": xs}, fetch_list=[loss])
    scope = static.global_scope()
    with static.program.recording_suspended():  # eager autograd
        w, b = (scope.vars[v.name].detach().clone().requires_grad_()
                for v in tprog.all_parameters())
        torch.mean((torch.from_numpy(xs) @ w + b) ** 2).backward()
    for v, t in zip(tprog.all_parameters(), (w, b)):
        np.testing.assert_allclose(scope.vars[v.name + "@GRAD"].numpy(),
                                   t.grad.numpy(), **TOL)


def test_dropout_draws_a_new_mask_at_every_run(both):
    """A random draw is recorded, not baked: each run draws anew, and a
    run from a generator's state equals the eager call from that state."""
    from paddle_tpu_torch.nn.layer.common import Dropout

    drop = Dropout(0.5)
    tprog = static.Program()
    with static.program_guard(tprog):
        x = static.data("x", [None, 64], "float32")
        y = drop(x)
    xs = np.ones((2, 64), np.float32)
    exe = static.Executor("cpu")
    torch.manual_seed(3)
    a, = exe.run(tprog, feed={"x": xs}, fetch_list=[y])
    b, = exe.run(tprog, feed={"x": xs}, fetch_list=[y])
    assert not np.array_equal(a, b)
    assert set(np.unique(a)) <= {0.0, 2.0}
    torch.manual_seed(3)
    with static.program.recording_suspended():
        eager = drop(torch.from_numpy(xs)).numpy()
    np.testing.assert_array_equal(a, eager)
