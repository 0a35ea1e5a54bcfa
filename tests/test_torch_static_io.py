"""The port's deployment path on the CPU, against the reference's:
``static.save_inference_model`` -> ``load_inference_model`` and
``inference.create_predictor`` (one artifact, many batch sizes), ``jit.save``
-> ``jit.load`` / the Predictor, ``static.save`` -> ``load_program`` and
continue, the Config knobs' warnings, and the refusal of the other
package's files.

The reference's single-device cases of ``tests/test_inference.py`` and
the same-process case of ``tests/test_program_serialization.py``, built
in both packages with the reference's parameters carried across
(``convert.static_scope_from_paddle_tpu``, by position in
``program.params``). Tolerance: float32 to 1e-5 relative, 1e-6 absolute
for values near 0 (``TOL``), for the MLPs against the reference and for
ERNIE's artifact against its own Executor (measured on the CPU: equal).
"""
import warnings

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch import convert, inference, jit, static  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch.models import ernie as ternie  # noqa: E402
from paddle_tpu_torch.nn.layer.common import Linear  # noqa: E402

# one intra-op thread: the suite's parallel workers share the CPU
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


def _mlp(pkg):
    x = pkg.static.data("x", [-1, 4], "float32")
    h = pkg.static.nn.fc(x, 8, activation="relu")
    return x, pkg.static.nn.fc(h, 2)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """The same MLP saved by each package, the port's from the
    reference's parameters: ``(port prefix, reference prefix)``."""
    d = tmp_path_factory.mktemp("artifacts")
    paddle.enable_static()
    pt.enable_static()
    try:
        with paddle.static.scope_guard(paddle.static.Scope()), \
                static.scope_guard(static.Scope()):
            jprog, tprog = paddle.static.Program(), static.Program()
            with paddle.static.program_guard(jprog):
                jx, jy = _mlp(paddle)
            with static.program_guard(tprog):
                tx, ty = _mlp(pt)
            convert.static_scope_from_paddle_tpu(
                {v.name: np.asarray(a) for v, a in jprog.params}, jprog,
                tprog)
            jexe, texe = paddle.static.Executor(), static.Executor("cpu")
            zeros = {"x": np.zeros((3, 4), np.float32)}
            jexe.run(jprog, feed=zeros, fetch_list=[jy])
            texe.run(tprog, feed=zeros, fetch_list=[ty])
            paddle.static.save_inference_model(str(d / "ref"), [jx], [jy],
                                               jexe, program=jprog)
            static.save_inference_model(str(d / "port"), [tx], [ty], texe,
                                        program=tprog)
            return str(d / "port"), str(d / "ref")
    finally:
        pt.disable_static()
        paddle.disable_static()


def _cpu_predictor(prefix, params=None):
    cfg = inference.Config(prefix + ".pdmodel", params)
    cfg.disable_gpu()
    return inference.create_predictor(cfg)


def _ref_predictor(prefix, params=None):
    from paddle_tpu import inference as jinf

    return jinf.create_predictor(jinf.Config(prefix + ".pdmodel", params))


def _x(bs):
    return np.random.default_rng(bs).normal(size=(bs, 4)).astype(np.float32)


def test_save_load_inference_model(artifacts):
    port, ref = artifacts
    prog, feeds, fetches = static.load_inference_model(
        port, static.Executor("cpu"))
    assert feeds == ["x"] and len(fetches) == 1
    jprog, _, _ = paddle.static.load_inference_model(ref)
    for bs in (3, 7):
        got = prog.run({"x": _x(bs)})[0]
        np.testing.assert_allclose(got, jprog.run({"x": _x(bs)})[0], **TOL)
        exe_out, = static.Executor("cpu").run(prog, feed={"x": _x(bs)},
                                              fetch_list=fetches)
        np.testing.assert_array_equal(exe_out, got)


def test_predictor_roundtrip(artifacts):
    port, ref = artifacts
    pred = _cpu_predictor(port)
    assert pred.get_input_names() == ["x"]
    h = pred.get_input_handle("x")
    h.copy_from_cpu(_x(3))
    assert pred.run()
    out = pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()
    assert h.shape() == [3, 4]
    np.testing.assert_allclose(out, _ref_predictor(ref).run([_x(3)])[0],
                               **TOL)


def test_predictor_dynamic_batch_from_one_artifact(artifacts):
    port, ref = artifacts
    pred, jpred = _cpu_predictor(port), _ref_predictor(ref)
    for bs in (1, 5, 16):
        outs = pred.run([_x(bs)])
        assert outs[0].shape == (bs, 2)
        np.testing.assert_allclose(outs[0], jpred.run([_x(bs)])[0], **TOL)


def test_run_list_api_and_params_read_both_ways(artifacts):
    """The list form of ``run``; and each package's ``.pdiparams`` serves
    the other's graph (the reference's pickle keys, parameters in
    ``program.params`` order and layout)."""
    port, ref = artifacts
    want = _ref_predictor(ref).run([_x(4)])[0]
    got = _cpu_predictor(port, ref + ".pdiparams").run([_x(4)])[0]
    np.testing.assert_allclose(got, want, **TOL)
    cross = _ref_predictor(ref, port + ".pdiparams").run([_x(4)])[0]
    np.testing.assert_allclose(np.asarray(cross), want, **TOL)


def test_jit_saved_layer_through_predictor_and_load(tmp_path):
    torch.manual_seed(0)
    model = torch.nn.Sequential(Linear(4, 8), torch.nn.ReLU(), Linear(8, 2))
    x = torch.randn(2, 4)
    with torch.no_grad():
        ref = model(x).numpy()
    prefix = str(tmp_path / "jit_model")
    jit.save(model, prefix, input_spec=[static.InputSpec([None, 4])])
    outs = _cpu_predictor(prefix).run([x.numpy()])
    np.testing.assert_allclose(outs[0], ref, **TOL)
    layer = jit.load(prefix, device="cpu")
    np.testing.assert_allclose(layer(x).numpy(), ref, **TOL)
    x5 = torch.randn(5, 4)
    with torch.no_grad():
        np.testing.assert_allclose(layer(x5).numpy(), model(x5).numpy(),
                                   **TOL)


def test_ernie_artifact_serves_two_batches(tmp_path):
    tm = ternie.ErnieForSequenceClassification(
        ternie.ernie_tiny(vocab_size=128, max_position_embeddings=64,
                          device="cpu",
                          generator=torch.Generator().manual_seed(0)), 3)
    prog, _, fetch = ternie.build_static_inference_program(tm, seq_len=16)
    prefix = str(tmp_path / "ernie")
    with static.scope_guard(static.Scope()):
        exe = static.Executor("cpu")
        ids = {bs: np.random.default_rng(bs).integers(0, 128, (bs, 16))
               for bs in (2, 5)}
        want = {bs: exe.run(prog, feed={"input_ids": i}, fetch_list=[fetch])[0]
                for bs, i in ids.items()}
        static.save_inference_model(prefix, [prog.feed_vars["input_ids"]],
                                    [fetch], exe, program=prog)
    pred = _cpu_predictor(prefix)
    for bs, i in ids.items():
        np.testing.assert_allclose(pred.run([i])[0], want[bs], **TOL)


def _build_training(pkg, adam):
    main, startup = pkg.static.Program(), pkg.static.Program()
    with pkg.static.program_guard(main, startup):
        x = pkg.static.data("x", [None, 8], "float32")
        y = pkg.static.data("y", [None, 1], "float32")
        h = pkg.static.nn.fc(x, 16, activation="relu")
        out = pkg.static.nn.fc(h, 1)
        loss = ((out - y) * (out - y)).mean()
        adam(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def _feeds(n):
    rng = np.random.default_rng(9)
    return [{"x": rng.normal(size=(8, 8)).astype(np.float32),
             "y": rng.normal(size=(8, 1)).astype(np.float32)}
            for _ in range(n)]


def test_same_process_round_trip_continues(tmp_path):
    """``static.save`` after two runs, ``load_program`` into a fresh
    scope, two more runs: the losses of an uninterrupted run, which are
    the reference's."""
    feeds = _feeds(4)
    paddle.enable_static()
    pt.enable_static()
    try:
        with paddle.static.scope_guard(paddle.static.Scope()):
            jmain, jstart, jloss = _build_training(paddle,
                                                   paddle.optimizer.Adam)
            jexe = paddle.static.Executor()
            want = [float(jexe.run(jmain, feed=f, fetch_list=[jloss])[0])
                    for f in feeds]
        ref_vars = {v.name: np.asarray(a) for v, a in jmain.params}
        exe = static.Executor("cpu")
        with static.scope_guard(static.Scope()):
            main, _, loss = _build_training(pt, topt.Adam)
            convert.static_scope_from_paddle_tpu(ref_vars, jmain, main)
            base = [float(exe.run(main, feed=f, fetch_list=[loss])[0])
                    for f in feeds]
        with static.scope_guard(static.Scope()):
            main2, _, loss2 = _build_training(pt, topt.Adam)
            convert.static_scope_from_paddle_tpu(ref_vars, jmain, main2)
            first = [float(exe.run(main2, feed=f, fetch_list=[loss2])[0])
                     for f in feeds[:2]]
            static.save(main2, str(tmp_path / "ckpt"))
        with static.scope_guard(static.Scope()):
            prog = static.load_program(str(tmp_path / "ckpt"))
            rest = [float(static.Executor("cpu").run(
                prog, feed=f, fetch_list=[prog.vars[loss2.name]])[0])
                for f in feeds[2:]]
    finally:
        pt.disable_static()
        paddle.disable_static()
    assert first + rest == base
    np.testing.assert_allclose(base, want, **TOL)


def test_reference_files_are_refused_naming_the_format(tmp_path, artifacts):
    _, ref = artifacts
    with pytest.raises(ValueError, match="StableHLO"):
        static.load_inference_model(ref, static.Executor("cpu"))
    paddle.enable_static()
    try:
        with paddle.static.scope_guard(paddle.static.Scope()):
            jmain, _, _ = _build_training(paddle, paddle.optimizer.Adam)
            paddle.static.save(jmain, str(tmp_path / "jckpt"))
    finally:
        paddle.disable_static()
    with pytest.raises(ValueError, match=r"paddle_tpu \(the JAX package\)"):
        static.load_program(str(tmp_path / "jckpt"))


def test_noop_knobs_warn_once_each_under_their_names():
    knobs = {"switch_ir_optim": (False,), "enable_memory_optim": (),
             "enable_mkldnn": (), "switch_use_feed_fetch_ops": (False,),
             "switch_specify_input_names": (True,),
             "enable_tensorrt_engine": (1 << 20, 8),
             "set_cpu_math_library_num_threads": (4,)}
    for k in knobs:
        inference.Config._warned_noops.discard(k)
    cfg = inference.Config("m")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        for k, args in knobs.items():
            getattr(cfg, k)(*args)
            getattr(cfg, k)(*args)  # a second call is silent
    msgs = [str(x.message) for x in w if issubclass(x.category, UserWarning)]
    for k in knobs:
        named = [m for m in msgs if f".{k}()" in m]
        assert len(named) == 1 and "NO effect" in named[0]


def test_dist_inference_takes_one_card_and_names_item_7b():
    cfg = inference.Config("m")
    cfg.enable_dist_inference()
    cfg.enable_dist_inference(1)
    assert cfg.dist_inference_degree() == 1
    with pytest.raises(NotImplementedError, match="7b"):
        cfg.enable_dist_inference(2)
    assert inference.get_version()


def test_create_generation_engine_wraps_the_serving_engine():
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTModel
    from paddle_tpu_torch.serving import GenerationEngine

    model = GPTModel(GPTConfig.preset("gpt2-tiny", vocab_size=64),
                     device="cpu")
    engine = inference.create_generation_engine(
        model, device="cpu", max_batch_size=2, buckets=(16,))
    assert isinstance(engine, GenerationEngine)
