"""paddle_tpu_torch.amp against paddle_tpu.amp on the CPU.

- The dtype plan (``cast_plan``) equals the reference's ``_cast_hook`` for
  every listed op name and some unlisted ones, at O1 and O2, bf16 and
  float16, over float32 / bf16 / float16 / int32 inputs: exact.
- Torch calls under ``auto_cast`` give the dtype the reference's op gives
  on the same inputs: exact.
- A ``gpt2-tiny`` float32 model under O1 and O2 bf16 (weights carried by
  ``convert``): the loss within 0.05 of the reference's (bf16 rounding of
  every matmul input through two layers and the LM head, in another
  order), and every gradient float32.
- ``decorate(O2)``, and the GradScaler flow (scale, unscale, the skipped
  inf step that halves the scale, growth after ``incr_every_n_steps``)
  against the reference: parameters within 1e-6, scales and
  ``state_dict`` equal.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.amp.auto_cast import _cast_hook  # noqa: E402
from paddle_tpu.models import gpt as jgpt  # noqa: E402
from paddle_tpu_torch import amp as tamp  # noqa: E402
from paddle_tpu_torch import convert  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch.amp.auto_cast import cast_plan  # noqa: E402
from paddle_tpu_torch.distributed.fleet.utils import recompute  # noqa: E402
from paddle_tpu_torch.models import gpt as tgpt  # noqa: E402
from paddle_tpu_torch.ops import flash_attention as tfa  # noqa: E402

# one intra-op thread: the suite's parallel workers share the CPU, and
# a torch thread pool in each would oversubscribe it
torch.set_num_threads(1)

_IN = ("float32", "bfloat16", "float16", "int32")
UNLISTED = ("add", "gelu", "embedding", "reshape", "dropout")


def _ref_plan(name, level, dtype):
    arrays = [jnp.zeros((2,), d) for d in _IN]
    with paddle.amp.auto_cast(level=level, dtype=dtype):
        plan = _cast_hook(name, arrays)
    return None if plan is None else [
        None if d is None else jnp.dtype(d).name for d in plan]


def _port_plan(name, level, dtype):
    tensors = [torch.zeros(2, dtype=getattr(torch, d)) for d in _IN]
    with tamp.auto_cast(level=level, dtype=dtype):
        plan = cast_plan(name, tensors)
    return None if plan is None else [
        None if d is None else str(d)[6:] for d in plan]


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize(
    "name", sorted(tamp.WHITE_LIST) + sorted(tamp.BLACK_LIST)
    + list(UNLISTED))
def test_cast_plan_matches_reference(name, level):
    assert tamp.WHITE_LIST == paddle.amp.WHITE_LIST
    assert tamp.BLACK_LIST == paddle.amp.BLACK_LIST
    for dtype in ("bfloat16", "float16"):
        assert _port_plan(name, level, dtype) == \
            _ref_plan(name, level, dtype), (name, level, dtype)


def _sdpa_ref(q, k, v):
    return paddle.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True)


# (label, port call, reference call, input shapes): the same op in both
CALLS = {
    "matmul": (lambda a, b: a @ b, paddle.matmul, [(4, 8), (8, 4)]),
    "linear": (lambda x, w, b: F.linear(x, w.t(), b),
               paddle.nn.functional.linear, [(4, 8), (8, 4), (4,)]),
    "einsum": (lambda a, b: torch.einsum("ij,jk->ik", a, b),
               lambda a, b: paddle.einsum("ij,jk->ik", a, b),
               [(4, 8), (8, 4)]),
    "layer_norm": (lambda x, w, b: F.layer_norm(x, (8,), w, b),
                   lambda x, w, b: paddle.nn.functional.layer_norm(
                       x, [8], w, b), [(4, 8), (8,), (8,)]),
    "softmax": (lambda x: torch.softmax(x, -1),
                lambda x: paddle.nn.functional.softmax(x, -1), [(4, 8)]),
    "log_softmax": (lambda x: torch.log_softmax(x, -1),
                    lambda x: paddle.nn.functional.log_softmax(x, -1),
                    [(4, 8)]),
    "exp": (torch.exp, paddle.exp, [(4, 8)]),
    "log": (torch.log, paddle.log, [(4, 8)]),
    "mean": (torch.mean, paddle.mean, [(4, 8)]),
    "sum": (lambda x: x.sum(), paddle.sum, [(4, 8)]),
    "pow": (lambda x: x ** 2, lambda x: paddle.pow(x, 2), [(4, 8)]),
    "gelu": (F.gelu, paddle.nn.functional.gelu, [(4, 8)]),
    "add": (lambda a, b: a + b, paddle.add, [(4, 8), (4, 8)]),
    "flash_attention": (
        lambda q, k, v: tfa.flash_attention(q, k, v, causal=True),
        _sdpa_ref, [(1, 128, 2, 64)] * 3),
}


@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("op", list(CALLS))
def test_torch_call_takes_the_reference_dtype(op, level, in_dtype):
    port_fn, ref_fn, shapes = CALLS[op]
    rng = np.random.default_rng(0)
    xs = [np.abs(rng.standard_normal(s)).astype(np.float32) + 0.5
          for s in shapes]
    tx = [torch.from_numpy(x).to(getattr(torch, in_dtype)) for x in xs]
    jx = [paddle.to_tensor(x).astype(in_dtype) for x in xs]
    with tamp.auto_cast(level=level):
        got = port_fn(*tx)
    with paddle.amp.auto_cast(level=level):
        want = ref_fn(*jx)
    assert str(got.dtype)[6:] == want.numpy().dtype.name, (op, got.dtype)


def test_custom_lists_match_reference():
    x = np.abs(np.random.default_rng(1).standard_normal((4, 8))) \
        .astype(np.float32)
    tx, jx = torch.from_numpy(x), paddle.to_tensor(x)
    kw = dict(custom_white_list=["exp"], custom_black_list=["gelu"])
    with tamp.auto_cast(**kw):
        t_exp = torch.exp(tx)
        t_gelu = F.gelu(tx.to(torch.bfloat16))
        t_mm = tx @ tx.t()
    with paddle.amp.auto_cast(**kw):
        j_exp = paddle.exp(jx)
        j_gelu = paddle.nn.functional.gelu(jx.astype("bfloat16"))
        j_mm = paddle.matmul(jx, jx.T)
    assert (t_exp.dtype, t_gelu.dtype, t_mm.dtype) == (
        torch.bfloat16, torch.float32, torch.bfloat16)
    assert [t.numpy().dtype.name for t in (j_exp, j_gelu, j_mm)] == \
        ["bfloat16", "float32", "bfloat16"]
    # a name on both custom lists is white, as in the reference
    with tamp.auto_cast(custom_white_list=["exp"],
                        custom_black_list=["exp"]):
        assert torch.exp(tx).dtype == torch.bfloat16
    # nested enable=False turns casting off inside, as in the reference
    with tamp.auto_cast():
        with tamp.auto_cast(enable=False):
            assert (tx @ tx.t()).dtype == torch.float32
        assert (tx @ tx.t()).dtype == torch.bfloat16
    assert (tx @ tx.t()).dtype == torch.float32


@pytest.fixture(scope="module")
def tiny_pair():
    cfg = dict(vocab_size=96, n_head=2, dropout=0.0)
    state = paddle.get_rng_state()
    try:
        paddle.seed(0)
        jm = jgpt.GPTForPretraining(jgpt.GPTModel(
            jgpt.GPTConfig.preset("gpt2-tiny", **cfg)))
    finally:
        paddle.set_rng_state(state)
    tm = tgpt.GPTForPretraining(tgpt.GPTModel(
        tgpt.GPTConfig.preset("gpt2-tiny", **cfg), device="cpu"))
    convert.load_paddle_tpu_state(tm, {k: np.asarray(v.numpy())
                                       for k, v in jm.state_dict().items()})
    toks = np.random.default_rng(3).integers(0, 96, (2, 128))
    return jm, tm, toks, np.roll(toks, -1, axis=1)


# measured on the CPU: logits within 7.8e-3 (one bf16 step at |x| in
# [1, 2); the largest |logit| is 1.58) at both levels; the loss within
# 5.3e-5 under O1 and 4.4e-4 under O2. The loss of all-zero logits is
# 0.019 from the reference's, and a log_softmax run in bf16 moves the O1
# loss by 8.8e-4: both fail.
LOSS_TOL = {"O1": 5e-4, "O2": 2e-3}
LOGITS_ATOL = 1.6e-2  # two bf16 steps at |x| in [1, 2)


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_gpt_tiny_loss_under_auto_cast_matches_reference(tiny_pair, level):
    """gpt2-tiny with float32 parameters: the bf16 logits agree with the
    reference's elementwise within LOGITS_ATOL and the float32 loss within
    LOSS_TOL[level]."""
    jm, tm, toks, labels = tiny_pair
    with paddle.amp.auto_cast(level=level):
        jlogits = jm(paddle.to_tensor(toks))
        jloss = jgpt.GPTPretrainingCriterion()(jlogits,
                                                paddle.to_tensor(labels))
    with tamp.auto_cast(level=level):
        tlogits = tm(torch.from_numpy(toks))
        tloss = tgpt.GPTPretrainingCriterion()(tlogits,
                                                torch.from_numpy(labels))
    assert tlogits.dtype == torch.bfloat16
    assert jlogits.numpy().dtype.name == "bfloat16"
    assert tloss.dtype == torch.float32
    np.testing.assert_allclose(
        tlogits.detach().float().numpy(),
        np.asarray(jlogits.numpy()).astype(np.float32),
        rtol=0, atol=LOGITS_ATOL)
    assert abs(float(tloss.detach()) - float(jloss)) <= LOSS_TOL[level]
    tloss.backward()
    for name, p in tm.named_parameters():
        assert p.grad.dtype == torch.float32, name
        assert torch.isfinite(p.grad).all(), name
    tm.zero_grad()


def test_auto_cast_belongs_to_the_thread_that_entered_it():
    """A second thread's flash_attention is not cast while the first
    thread is inside auto_cast, and a second thread entering and leaving
    auto_cast leaves the first thread's state as it was."""
    import threading

    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 8, 2, 16))
                                .astype(np.float32)) for _ in range(3))
    inside, done = threading.Event(), threading.Event()
    seen = {}

    def other():
        inside.wait()
        seen["plain"] = tfa.flash_attention(q, k, v, causal=True).dtype
        with tamp.auto_cast(dtype="float16"):
            seen["own"] = tfa.flash_attention(q, k, v, causal=True).dtype
        seen["after"] = tamp.amp_state().enabled
        done.set()

    t = threading.Thread(target=other)
    t.start()
    with tamp.auto_cast(level="O1", dtype="bfloat16"):
        inside.set()
        assert done.wait(30)
        assert tamp.amp_state().enabled
        assert tamp.amp_state().dtype == torch.bfloat16
        assert tfa.flash_attention(q, k, v, causal=True).dtype == \
            torch.bfloat16
    t.join()
    assert seen == {"plain": torch.float32, "own": torch.float16,
                    "after": False}
    assert not tamp.amp_state().enabled


def test_recompute_under_auto_cast_casts_as_the_forward():
    torch.manual_seed(0)
    lin, ln = torch.nn.Linear(8, 8), torch.nn.LayerNorm(8)
    x = torch.randn(4, 8, requires_grad=True)

    def block(h):
        return ln(lin(h))

    grads = []
    for use in (False, True):
        with tamp.auto_cast():
            y = recompute(block, x) if use else block(x)
        assert y.dtype == torch.float32
        y.pow(2).sum().backward()
        grads.append([t.grad.clone() for t in (x, lin.weight, ln.weight)])
        for t in (x, lin.weight, ln.weight):
            t.grad = None
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_decorate_o2_matches_reference():
    lin = torch.nn.Linear(4, 4)
    opt = topt.Adam(0.1, parameters=lin.parameters())
    model, opt2 = tamp.decorate(lin, opt, level="O2", dtype="bfloat16")
    assert model is lin and opt2 is opt
    assert lin.weight.dtype == torch.bfloat16 and opt._multi_precision
    jl = paddle.nn.Linear(4, 4)
    jopt = paddle.optimizer.Adam(0.1, parameters=jl.parameters())
    jl, jopt = paddle.amp.decorate(jl, jopt, level="O2", dtype="bfloat16")
    assert jl.weight.dtype == paddle.bfloat16 and jopt._multi_precision
    # O1 leaves parameters alone; a list comes back as a list
    lin1 = torch.nn.Linear(4, 4)
    assert tamp.decorate([lin1], level="O1") == [lin1]
    assert lin1.weight.dtype == torch.float32


def _scaler_run(pkg, w0):
    """SGD on one weight under GradScaler(init 4, incr every 2 steps):
    grads 3 * w, an inf step at call 2. Returns the weight after each
    step, the scales and the final state_dict."""
    if pkg == "torch":
        w = torch.tensor(w0, requires_grad=True)
        opt = topt.SGD(0.5, parameters=[w])
        scaler = tamp.GradScaler(init_loss_scaling=4.0, incr_every_n_steps=2)
    else:
        w = paddle.to_tensor(w0, stop_gradient=False)
        opt = paddle.optimizer.SGD(0.5, parameters=[w])
        scaler = paddle.amp.GradScaler(init_loss_scaling=4.0,
                                       incr_every_n_steps=2)
    ws, scales = [], []
    for i in range(5):
        loss = (w * w).sum() * 1.5
        if i == 2:
            loss = loss * np.inf
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        ws.append(np.array(w.detach().numpy() if pkg == "torch"
                           else w.numpy()))
        scales.append(float(scaler.get_loss_scaling()))
    return ws, scales, scaler.state_dict()


def test_grad_scaler_flow_matches_reference():
    w0 = np.array([1.0, -2.0], np.float32)
    tws, tscales, tsd = _scaler_run("torch", w0)
    jws, jscales, jsd = _scaler_run("paddle", w0)
    # step 2 saw inf: skipped (weights unchanged) and the scale halved;
    # two good steps later it doubles back
    np.testing.assert_array_equal(tws[2], tws[1])
    assert tscales == [4.0, 8.0, 4.0, 4.0, 8.0]
    assert tscales == jscales
    for a, b in zip(tws, jws):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    assert tsd == jsd
    fresh = tamp.GradScaler()
    fresh.load_state_dict(tsd)
    assert fresh.state_dict()["scale"] == tsd["scale"]


def test_grad_scaler_densifies_a_sparse_gradient():
    emb = torch.nn.Embedding(6, 3, sparse=True)
    opt = topt.SGD(0.1, parameters=emb.parameters())
    scaler = tamp.GradScaler(init_loss_scaling=8.0)
    before = emb.weight.detach().clone()
    scaler.scale(emb(torch.tensor([1, 1, 4])).sum()).backward()
    scaler.step(opt)
    assert not emb.weight.grad.is_sparse
    want = before.clone()
    want[1] -= 0.2
    want[4] -= 0.1
    torch.testing.assert_close(emb.weight.detach(), want)
