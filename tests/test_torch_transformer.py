"""The port's Paddle-API layers, initializers, fused layers and
memory_efficient_attention against the JAX package's, with the reference's
weights carried across by ``paddle_tpu_torch.convert``.

Sizes: width 128, 2 heads (head_dim 64), sequences of 8, float32. On the
CPU both packages take plain attention (the port's plain route, the
reference's XLA path), the path every masked or cross-length call takes on
the card too. Tolerance: 1e-4 absolute and relative for outputs and
gradients (float32 in both frameworks, summed in another order). The
random initializers are held to the moments and bounds of the reference's
formulas (threefry is not reproduced); fans and gains exactly.
"""
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.incubate.nn as jinc  # noqa: E402
import paddle_tpu.nn as jnn  # noqa: E402
import paddle_tpu.nn.functional as jF  # noqa: E402
from paddle_tpu.nn import initializer as jinit  # noqa: E402
from paddle_tpu_torch import convert  # noqa: E402
from paddle_tpu_torch import nn as tnn  # noqa: E402
from paddle_tpu_torch.incubate import nn as tinc  # noqa: E402
from paddle_tpu_torch.nn import functional as tF  # noqa: E402
from paddle_tpu_torch.nn import initializer as tinit  # noqa: E402

# one intra-op thread: the suite's parallel workers share the CPU, and
# a torch thread pool in each would oversubscribe it
torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
# bert_tiny's widths, so that the two files share compiled shapes
D, HEADS, FF, B, T = 128, 2, 512, 2, 8


def _seeded(fn, seed=0):
    # the reference's global generator is put back after, so later tests in
    # this process draw what they would have drawn without this file
    state = paddle.get_rng_state()
    try:
        paddle.seed(seed)
        return fn()
    finally:
        paddle.set_rng_state(state)


def _linear_names(jm):
    return {f"{n}.weight" for n, m in jm.named_sublayers()
            if type(m).__name__ in ("Linear", "FusedLinear")}


def _pair(make_ref, make_port, seed=0):
    """The reference module (seeded) and the port's with its weights."""
    jm = _seeded(make_ref, seed)
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = make_port()
    convert.load_paddle_tpu_state(tm, state)
    return jm, tm


def _arrays(*shapes, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _j(a, grad=False):
    return paddle.to_tensor(a, stop_gradient=not grad)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _close(got, want, what=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want.numpy() if hasattr(
        want, "numpy") else want), **TOL, err_msg=what)


def _check_grads(jm, tm):
    linear = _linear_names(jm)
    got = dict(tm.named_parameters())
    want = dict(jm.named_parameters())
    assert sorted(got) == sorted(want)
    for name, p in want.items():
        if p.grad is None:  # an unused LayerNorm (fused post-norm's pre_ln)
            assert got[name].grad is None, name
            continue
        g = np.asarray(p.grad.numpy())
        _close(got[name].grad, g.T if name in linear else g, name)


def _run(jm, tm, ins, call=lambda m, *a: m(*a), grad_in=(0,)):
    """Forward both on the same inputs and backward ``sum(out * w)`` for a
    fixed random ``w``; compare the outputs, the inputs' gradients and
    every parameter's gradient."""
    jin = [_j(a, i in grad_in) if isinstance(a, np.ndarray) else a
           for i, a in enumerate(ins)]
    tin = [_t(a, i in grad_in) if isinstance(a, np.ndarray) else a
           for i, a in enumerate(ins)]
    jout, tout = call(jm, *jin), call(tm, *tin)
    (w,) = _arrays(tuple(tout.shape), seed=9)
    (jout * _j(w)).sum().backward()
    (tout * _t(w)).sum().backward()
    _close(tout, jout, "output")
    for i in grad_in:
        _close(tin[i].grad, jin[i].grad, f"input {i} grad")
    _check_grads(jm, tm)
    return jout, tout


# ---------------------------------------------------------- initializers --
@pytest.mark.parametrize("shape", [(), (7,), (32, 64), (64, 32),
                                   (16, 8, 3, 3), (4, 6, 5)])
def test_fans_equal_the_references(shape):
    assert tinit._fans(shape) == jinit._fans(shape)


@pytest.mark.parametrize("name,param", [
    ("sigmoid", None), ("linear", None), ("conv2d", None), ("tanh", None),
    ("relu", None), ("leaky_relu", None), ("leaky_relu", 0.0),
    ("leaky_relu", 0.2), ("selu", None)])
def test_gains_equal_the_references(name, param):
    assert tinit.calculate_gain(name, param) == \
        jinit.calculate_gain(name, param)


@pytest.mark.parametrize("make", [
    lambda: tinit.Constant(0.25),
    lambda: tinit.Assign(np.arange(12.0).reshape(3, 4)),
    lambda: tinit.Dirac(groups=2)])
def test_deterministic_initializers_equal_the_references(make):
    port = make()
    ref = getattr(jinit, type(port).__name__)(
        *([port.value] if hasattr(port, "value") else [port.groups]))
    shape = (3, 4) if not isinstance(port, tinit.Dirac) else (4, 3, 3, 3)
    got = port(torch.empty(shape))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref(shape, "float32")))


def test_assign_refuses_another_shape():
    with pytest.raises(ValueError, match="shape mismatch"):
        tinit.Assign(np.zeros((2, 2)))(torch.empty(3, 2))


@pytest.mark.parametrize("shape", [(48, 32), (32, 48), (4, 3, 16)])
def test_orthogonal_is_orthonormal(shape):
    # the reference's property (jax.nn.initializers.orthogonal): orthonormal
    # columns, or rows when there are fewer rows, times the gain
    g = torch.Generator().manual_seed(0)
    m = tinit.Orthogonal(gain=2.0)(torch.empty(shape), g).numpy()
    m = m.reshape(-1, shape[-1]) / 2.0
    gram = m.T @ m if m.shape[0] >= m.shape[1] else m @ m.T
    np.testing.assert_allclose(gram, np.eye(len(gram)), atol=1e-5)


# name, args, (mean, std, low, high) from the reference's formulas for a
# [256, 512] tensor: fans (256, 512), leaky_relu's gain at slope 0 (0.01)
_FI, _FO = jinit._fans((256, 512))
_XU = math.sqrt(6 / (_FI + _FO))
_KG = jinit.calculate_gain("leaky_relu", 0.0)
_KU = _KG * math.sqrt(3 / _FI)
_TN_STD = 0.3 * 0.8796256610342398  # a standard normal cut at +-2
_RANDOM = [
    ("Normal", (0.5, 2.0), (0.5, 2.0, None, None)),
    ("Uniform", (-0.5, 1.5), (0.5, 2 / math.sqrt(12), -0.5, 1.5)),
    ("TruncatedNormal", (0.1, 0.3), (0.1, _TN_STD, -0.5, 0.7)),
    ("XavierUniform", (), (0.0, _XU / math.sqrt(3), -_XU, _XU)),
    ("XavierNormal", (), (0.0, math.sqrt(2 / (_FI + _FO)), None, None)),
    ("KaimingUniform", (), (0.0, _KU / math.sqrt(3), -_KU, _KU)),
    ("KaimingNormal", (), (0.0, _KG / math.sqrt(_FI), None, None))]


@pytest.mark.parametrize("name,args,want", _RANDOM,
                         ids=[r[0] for r in _RANDOM])
def test_random_initializers_draw_the_references_distribution(name, args,
                                                              want):
    mean, std, lo, hi = want
    g = torch.Generator().manual_seed(3)
    got = getattr(tinit, name)(*args)(torch.empty(256, 512), g).numpy()
    # 131072 draws: the mean within 4 standard errors, the spread within 1%
    assert abs(got.mean() - mean) < 4 * std / math.sqrt(got.size)
    assert abs(got.std() / std - 1) < 0.01
    if lo is not None:  # within the bounds, reaching them
        span = hi - lo
        assert got.min() >= lo - 1e-6 and got.max() <= hi + 1e-6
        assert got.min() < lo + 0.01 * span and got.max() > hi - 0.01 * span


def test_linear_reads_the_references_fans():
    # KaimingUniform's bound is sqrt(3 / fan_in) * gain: fan_in is the
    # reference's `in` (48), though torch stores the weight [out, in]
    attr = lambda: jnn.ParamAttr(initializer=jinit.KaimingUniform())  # noqa
    jm = _seeded(lambda: jnn.Linear(48, 512, weight_attr=attr()))
    tm = tnn.Linear(48, 512, weight_attr=tnn.ParamAttr(
        initializer=tinit.KaimingUniform()))
    bound = tinit.calculate_gain("leaky_relu", 0.0) * math.sqrt(3 / 48)
    for w in (np.asarray(jm.weight.numpy()), tm.weight.detach().numpy()):
        assert np.abs(w).max() <= bound and np.abs(w).max() > 0.98 * bound
    assert tuple(tm.weight.shape) == (512, 48)


def test_param_attr_reaches_the_parameter():
    attr = tnn.ParamAttr(learning_rate=0.5, trainable=False, need_clip=False)
    m = tnn.Linear(4, 3, weight_attr=attr, bias_attr=False)
    assert m.bias is None
    assert m.weight.optimize_attr == {"learning_rate": 0.5}
    assert not m.weight.requires_grad and m.weight.need_clip is False
    ln = tnn.LayerNorm(6, weight_attr=False, bias_attr=False)
    assert ln.weight is None and ln.bias is None


def test_embedding_padding_row_is_zero_and_looks_up_zeros():
    jm, tm = _pair(lambda: jnn.Embedding(10, 8, padding_idx=2),
                   lambda: tnn.Embedding(10, 8, padding_idx=2))
    assert not tm.weight[2].any()
    with torch.no_grad():
        tm.weight[2] = 1.0  # a loaded row: the lookup still gives zeros
    ids = np.array([[1, 2, 3, 2]])
    out = tm(torch.from_numpy(ids))
    assert not out[0, 1].any() and not out[0, 3].any()
    _close(out[:, [0, 2]], np.asarray(jm(_j(ids)).numpy())[:, [0, 2]])


# ------------------------------------------------------ transformer layers --
def _mha_pair(**kw):
    return _pair(lambda: jnn.MultiHeadAttention(D, HEADS, **kw),
                 lambda: tnn.MultiHeadAttention(D, HEADS, **kw))


def _masks():
    """A bool keep-mask [B, T, T] with a fully masked row, and an additive
    float mask [B, 1, T, T]."""
    rng = np.random.default_rng(4)
    keep = rng.random((B, T, T)) > 0.3
    keep[0, 3] = False
    add = np.where(rng.random((B, 1, T, T)) > 0.2, 0.0, -1e4)
    return keep, add.astype(np.float32)


@pytest.mark.parametrize("mask", [None, "bool", "float"])
def test_mha_self_attention_matches(mask):
    jm, tm = _mha_pair()
    (x,) = _arrays((B, T, D))
    keep, add = _masks()
    m = {None: None, "bool": keep, "float": add}[mask]
    ins = [x] if m is None else [x, x, x, m]
    _run(jm, tm, ins)


def test_mha_cross_attention_with_kdim_and_weights_matches():
    jm, tm = _mha_pair(kdim=96, vdim=96, need_weights=True)
    q, k, v = _arrays((B, T, D), (B, T, 96), (B, T, 96))
    keep = np.random.default_rng(5).random((B, T, T)) > 0.4
    jw = tw = None

    def call(m, *a):
        nonlocal jw, tw
        out, w = m(*a)
        if isinstance(m, torch.nn.Module):
            tw = w
        else:
            jw = w
        return out

    _run(jm, tm, [q, k, v, keep], call=call, grad_in=(0, 1, 2))
    _close(tw, jw, "weights")


def test_mha_caches_match():
    jm, tm = _mha_pair()
    x, mem, step = _arrays((B, T, D), (B, T, D), (B, 1, D))
    # StaticCache over a memory, then an incremental Cache grown by 2 steps
    js = jm.gen_cache(_j(mem), _j(mem), type=jnn.MultiHeadAttention.
                      StaticCache)
    ts = tm.gen_cache(_t(mem), _t(mem), type=tnn.MultiHeadAttention.
                      StaticCache)
    _close(tm(_t(x), cache=ts), jm(_j(x), cache=js), "static cache")
    jc = jm.gen_cache(_j(x), type=jnn.MultiHeadAttention.Cache)
    tc = tm.gen_cache(_t(x), type=tnn.MultiHeadAttention.Cache)
    for _ in range(2):
        jo, jc = jm(_j(step), cache=jc)
        to, tc = tm(_t(step), cache=tc)
        _close(to, jo, "incremental cache")
    _close(tc.k, jc.k, "grown cache")


@pytest.mark.parametrize("normalize_before", [False, True])
def test_encoder_matches(normalize_before):
    def make(nn_):
        return lambda: nn_.TransformerEncoder(nn_.TransformerEncoderLayer(
            D, HEADS, FF, dropout=0.0, activation="gelu",
            normalize_before=normalize_before), 2,
            nn_.LayerNorm(D) if normalize_before else None)

    jm, tm = _pair(make(jnn), make(tnn))
    (x,) = _arrays((B, T, D))
    keep, _ = _masks()
    _run(jm, tm, [x, keep[:, None]])


@pytest.mark.parametrize("normalize_before", [False, True])
def test_decoder_matches(normalize_before):
    def make(nn_):
        return lambda: nn_.TransformerDecoder(nn_.TransformerDecoderLayer(
            D, HEADS, FF, dropout=0.0,
            normalize_before=normalize_before), 2)

    jm, tm = _pair(make(jnn), make(tnn))
    tgt, mem = _arrays((B, T, D), (B, T, D))
    causal = np.tril(np.ones((T, T), bool))
    _run(jm, tm, [tgt, mem, causal], grad_in=(0, 1))


def test_decoder_caches_match():
    def make(nn_):
        return lambda: nn_.TransformerDecoder(nn_.TransformerDecoderLayer(
            D, HEADS, FF, dropout=0.0), 2)

    jm, tm = _pair(make(jnn), make(tnn))
    mem, step = _arrays((B, T, D), (B, 1, D))
    jc, tc = jm.gen_cache(_j(mem)), tm.gen_cache(_t(mem))
    jo, jc = jm(_j(step), _j(mem), cache=jc)
    to, tc = tm(_t(step), _t(mem), cache=tc)
    _close(to, jo, "decoder step")
    _close(tc[1][0].k, jc[1][0].k, "grown self-attention cache")


def test_transformer_and_its_causal_mask_match():
    jm, tm = _pair(lambda: jnn.Transformer(D, HEADS, 1, 1, FF, dropout=0.0),
                   lambda: tnn.Transformer(D, HEADS, 1, 1, FF, dropout=0.0))
    src, tgt = _arrays((B, T, D), (B, T, D))
    jmask = jm.generate_square_subsequent_mask(T)
    tmask = tm.generate_square_subsequent_mask(T)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask.numpy()))
    _run(jm, tm, [src, tgt, None, np.asarray(jmask.numpy())],
         grad_in=(0, 1))


def test_reference_copies_one_layer_the_port_initialises_each():
    """Reference fault (ROADMAP queue 3): TransformerEncoder deep-copies its
    first layer, so every layer starts from the same weights."""
    def first_weights(enc):
        return [np.asarray(layer.linear1.weight.detach().numpy()
                           if isinstance(layer, torch.nn.Module)
                           else layer.linear1.weight.numpy())
                for layer in enc.layers]

    ref = first_weights(_seeded(lambda: jnn.TransformerEncoder(
        jnn.TransformerEncoderLayer(D, HEADS, FF), 3)))
    port = first_weights(tnn.TransformerEncoder(
        tnn.TransformerEncoderLayer(D, HEADS, FF), 3))
    assert all(np.array_equal(ref[0], w) for w in ref[1:])
    assert not any(np.array_equal(port[0], w) for w in port[1:])


# ------------------------------------------------------------ fused layers --
@pytest.mark.parametrize("normalize_before", [False, True])
def test_fused_attention_and_feed_forward_match(normalize_before):
    jm, tm = _pair(
        lambda: jinc.FusedMultiHeadAttention(
            D, HEADS, dropout_rate=0.0, attn_dropout_rate=0.0,
            normalize_before=normalize_before),
        lambda: tinc.FusedMultiHeadAttention(
            D, HEADS, dropout_rate=0.0, attn_dropout_rate=0.0,
            normalize_before=normalize_before))
    (x,) = _arrays((B, T, D))
    _, add = _masks()
    _run(jm, tm, [x, add])
    jm, tm = _pair(
        lambda: jinc.FusedFeedForward(D, FF, dropout_rate=0.0,
                                      activation="gelu",
                                      normalize_before=normalize_before),
        lambda: tinc.FusedFeedForward(D, FF, dropout_rate=0.0,
                                      activation="gelu",
                                      normalize_before=normalize_before))
    _run(jm, tm, [x])


def test_fused_encoder_layer_and_multi_transformer_match():
    jm, tm = _pair(
        lambda: jinc.FusedTransformerEncoderLayer(D, HEADS, FF, 0.0),
        lambda: tinc.FusedTransformerEncoderLayer(D, HEADS, FF, 0.0))
    (x,) = _arrays((B, T, D))
    _run(jm, tm, [x])
    jm, tm = _pair(
        lambda: jinc.FusedMultiTransformer(D, HEADS, FF, num_layers=2),
        lambda: tinc.FusedMultiTransformer(D, HEADS, FF, num_layers=2))
    _run(jm, tm, [x, None, [object()]])  # caches are ignored


def test_fused_qkv_proj_keeps_the_references_column_order():
    # q, k and v of head h come from columns [s, h, :] of the packed
    # projection in both packages: the port's q equals the reference's
    # split of the converted weight
    jm, tm = _pair(lambda: jinc.FusedMultiHeadAttention(D, HEADS),
                   lambda: tinc.FusedMultiHeadAttention(D, HEADS))
    w = np.asarray(jm.qkv_proj.weight.numpy()).reshape(D, 3, HEADS, D //
                                                       HEADS)
    got = tm.qkv_proj.weight.detach().numpy().reshape(3, HEADS, D // HEADS,
                                                      D)
    np.testing.assert_array_equal(got, w.transpose(1, 2, 3, 0))


@pytest.mark.parametrize("bias", ["none", "causal", "tensor",
                                  "causal_tensor"])
def test_memory_efficient_attention_matches(bias):
    q, k, v = _arrays((B, T, HEADS, 64), (B, T, HEADS, 64),
                      (B, T, HEADS, 64))
    (b,) = _arrays((B, HEADS, T, T), seed=6)

    def attn_bias(mod, tensor):
        return {"none": None, "causal": mod.LowerTriangularMask(),
                "tensor": tensor,
                "causal_tensor": mod.LowerTriangularMaskWithTensorBias(
                    tensor)}[bias]

    jq, jk, jv = (_j(a, True) for a in (q, k, v))
    tq, tk, tv = (_t(a, True) for a in (q, k, v))
    jo = jinc.memory_efficient_attention(jq, jk, jv,
                                         attn_bias(jinc, _j(b)), scale=0.2)
    to = tinc.memory_efficient_attention(tq, tk, tv,
                                         attn_bias(tinc, _t(b)), scale=0.2)
    _close(to, jo)
    jo.sum().backward()
    to.sum().backward()
    for g, w in ((tq, jq), (tk, jk), (tv, jv)):
        _close(g.grad, w.grad)


def test_identity_loss_matches():
    (x,) = _arrays((3, 4))
    for red in ("sum", "mean", "none", 0, 1, 2):
        _close(tinc.identity_loss(_t(x), red),
               jinc.identity_loss(_j(x), red))
    with pytest.raises(ValueError):
        tinc.identity_loss(_t(x), "max")


# --------------------------------------------------------- functional ops --
@pytest.mark.parametrize("kw", [
    dict(), dict(ignore_index=2), dict(reduction="sum"),
    dict(reduction="none"), dict(label_smoothing=0.1), dict(weight=True),
    dict(soft_label=True), dict(use_softmax=False)])
def test_cross_entropy_matches(kw):
    kw = dict(kw)
    logits, w = _arrays((6, 5), (5,))
    labels = np.array([0, 2, 4, 2, 1, 3])
    if kw.pop("weight", False):
        kw["weight"] = np.abs(w)
    if kw.get("soft_label"):
        labels = np.random.default_rng(2).dirichlet(np.ones(5), 6).astype(
            np.float32)
    if kw.get("use_softmax") is False:
        logits = np.abs(logits) / np.abs(logits).sum(-1, keepdims=True)
    tkw = {k: (_t(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    jkw = {k: (_j(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    _close(tF.cross_entropy(_t(logits), _t(labels), **tkw),
           jF.cross_entropy(_j(logits), _j(labels), **jkw))


def test_activations_match():
    (x,) = _arrays((64,))
    for name in ("gelu", "relu", "tanh"):
        _close(getattr(tF, name)(_t(x)), getattr(jF, name)(_j(x)), name)
    _close(tF.gelu(_t(x), approximate=True),
           jF.gelu(_j(x), approximate=True))


@pytest.mark.parametrize("mode,axis", [("upscale_in_train", None),
                                       ("downscale_in_infer", None),
                                       ("upscale_in_train", [0])])
def test_dropout_keeps_its_share_and_follows_its_key(mode, axis):
    x = torch.ones(4096, 64)
    key = torch.tensor([5, 7])
    a = tF.dropout(x, 0.25, axis, True, mode, key=key, site=3)
    assert torch.equal(a, tF.dropout(x, 0.25, axis, True, mode, key=key,
                                     site=3))
    assert not torch.equal(a, tF.dropout(x, 0.25, axis, True, mode,
                                         key=key, site=4))
    kept = a != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.03
    scale = 1 / 0.75 if mode == "upscale_in_train" else 1.0
    assert torch.allclose(a[kept], torch.full_like(a[kept], scale))
    if axis is not None:  # one decision per row
        assert torch.equal(kept, kept[:, :1].expand_as(kept))
    infer = tF.dropout(x, 0.25, axis, False, mode)
    assert torch.equal(infer, x * (0.75 if mode == "downscale_in_infer"
                                   else 1.0))
