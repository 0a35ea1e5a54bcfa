"""The port's BERT and ERNIE against the JAX package's, with the reference's
weights carried across by ``paddle_tpu_torch.convert``.

Models: ``bert_tiny`` / ``ernie_tiny`` (2 layers, hidden 128, 2 heads:
head_dim 64, the kernels' head size) at vocab 128, batch 2 x 8, float32,
dropout 0 where outputs are compared. On the CPU both take plain attention
(the port's plain route, the reference's XLA path), which a padded batch
takes on the card too. Tolerance: 1e-4 absolute and relative for logits,
pooled outputs, losses and gradients, and for the parameters after three
AdamW steps (float32 in both frameworks, summed in another order; Adam's
first steps are lr * sign(grad), so elements whose gradient is within 1e-6
of zero in either package are left out of that one comparison).

The reference's eager loop is the yardstick for training, not its
``jit.TrainStep``, which advances Adam's step count twice per call
(ROADMAP queue 3).
"""
import copy

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.incubate.nn as jinc  # noqa: E402
from paddle_tpu.models import bert as jbert  # noqa: E402
from paddle_tpu.models import ernie as jernie  # noqa: E402
from paddle_tpu_torch import convert  # noqa: E402
from paddle_tpu_torch import jit as tjit  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch.incubate import nn as tinc  # noqa: E402
from paddle_tpu_torch.models import bert as tbert  # noqa: E402
from paddle_tpu_torch.models import ernie as ternie  # noqa: E402

# one intra-op thread: the suite's parallel workers share the CPU, and
# a torch thread pool in each would oversubscribe it
torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
V, B, T, LR = 128, 2, 8, 1e-3
NO_DROPOUT = dict(vocab_size=V, hidden_dropout_prob=0.0,
                  attention_probs_dropout_prob=0.0)


def _seeded(fn, seed=0):
    state = paddle.get_rng_state()
    try:
        paddle.seed(seed)
        return fn()
    finally:
        paddle.set_rng_state(state)


def _np_state(jm):
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _linear_names(jm):
    return {f"{n}.weight" for n, m in jm.named_sublayers()
            if type(m).__name__ in ("Linear", "FusedLinear")}


def _pretraining_pair(**over):
    cfg = dict(NO_DROPOUT, **over)
    jm = _seeded(lambda: jbert.BertForPretraining(jbert.bert_tiny(**cfg)))
    tm = tbert.BertForPretraining(tbert.bert_tiny(device="cpu", **cfg))
    convert.load_paddle_tpu_state(tm, _np_state(jm))
    return jm, tm


@pytest.fixture(scope="module")
def pretraining_pair():
    return _pretraining_pair()


def _batch(seed=0, padded=False):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, V, (B, T))
    mask = np.ones((B, T), np.int64)
    if padded:  # the second sequence is 5 tokens and 3 pads
        ids[1, 5:] = 0
        mask[1, 5:] = 0
    nsp = rng.integers(0, 2, (B, 1))
    return ids, mask, nsp


def _close(got, want, what=""):
    np.testing.assert_allclose(
        got.detach().float().numpy() if isinstance(got, torch.Tensor)
        else got, np.asarray(want.numpy()), **TOL, err_msg=what)


def _check_grads(jm, tm):
    linear = _linear_names(jm)
    got = dict(tm.named_parameters())
    want = dict(jm.named_parameters())
    assert sorted(got) == sorted(want)
    for name, p in want.items():
        g = np.asarray(p.grad.numpy())
        np.testing.assert_allclose(got[name].grad.numpy(),
                                   g.T if name in linear else g, **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("padded", [False, True])
def test_pretraining_logits_pooled_loss_and_every_grad_match(
        pretraining_pair, padded):
    jm, tm = pretraining_pair
    jm.clear_gradients()
    tm.zero_grad(set_to_none=True)
    ids, mask, nsp = _batch(padded=padded)
    jmask = paddle.to_tensor(mask) if padded else None
    tmask = torch.from_numpy(mask) if padded else None
    jscores, jrel = jm(paddle.to_tensor(ids), attention_mask=jmask)
    tscores, trel = tm(torch.from_numpy(ids), attention_mask=tmask)
    jloss = jbert.BertPretrainingCriterion(V)(
        jscores, jrel, paddle.to_tensor(ids), paddle.to_tensor(nsp))
    tloss = tbert.BertPretrainingCriterion(V)(
        tscores, trel, torch.from_numpy(ids), torch.from_numpy(nsp))
    jloss.backward()
    tloss.backward()
    _close(tscores, jscores, "mlm logits")
    _close(trel, jrel, "nsp logits")
    _close(tloss, jloss, "loss")
    _check_grads(jm, tm)
    with torch.no_grad():
        tseq, tpooled = tm.bert(torch.from_numpy(ids), attention_mask=tmask)
    jseq, jpooled = jm.bert(paddle.to_tensor(ids), attention_mask=jmask)
    _close(tseq, jseq, "sequence output")
    _close(tpooled, jpooled, "pooled")


def test_tied_decoder_weight_is_one_parameter(pretraining_pair):
    _, tm = pretraining_pair
    emb = tm.bert.embeddings.word_embeddings.weight
    assert tm.cls.decoder_weight is emb
    assert len(list(tm.parameters())) == len(tm.state_dict()) == 46
    assert "cls.decoder_weight" not in tm.state_dict()
    opt = topt.AdamW(learning_rate=LR, parameters=tm.parameters())
    assert sum(p is emb for p in opt._parameter_list) == 1


def test_reference_mlm_loss_counts_minus_100_labels_port_drops_them(
        pretraining_pair):
    """Reference fault (ROADMAP queue 3): its cross_entropy drops a label
    only for ignore_index >= 0, so BertPretrainingCriterion looks the -100
    labels up, as class V - 100 (JAX's negative index; NaN for V <= 100),
    and averages them in."""
    jm, tm = pretraining_pair
    ids, _, nsp = _batch(seed=2)
    with torch.no_grad():
        scores, rel = tm(torch.from_numpy(ids))
    # labels the model favours, so the kept labels' mean stands apart
    labels = scores.argmax(-1).numpy()
    labels[:, ::2] = -100
    got = float(tbert.BertPretrainingCriterion(V)(
        scores, rel, torch.from_numpy(labels), torch.from_numpy(nsp)))
    logp = torch.log_softmax(scores.reshape(-1, V).double(), -1).numpy()
    lab = labels.reshape(-1)
    keep = lab != -100
    nsp_loss = -torch.log_softmax(rel.double(), -1).numpy()[
        np.arange(B), nsp[:, 0]].mean()
    kept = -logp[keep, lab[keep]].mean() + nsp_loss
    wrapped = -logp[np.arange(len(lab)), lab % V].mean() + nsp_loss
    assert abs(kept - wrapped) > 1e-2
    np.testing.assert_allclose(got, kept, **TOL)
    js, jr = jm(paddle.to_tensor(ids))
    ref = float(jbert.BertPretrainingCriterion(V)(
        js, jr, paddle.to_tensor(labels), paddle.to_tensor(nsp)))
    np.testing.assert_allclose(ref, wrapped, **TOL)


def test_sequence_classification_matches():
    ids, mask, _ = _batch(seed=3, padded=True)
    jm = _seeded(lambda: jbert.BertForSequenceClassification(
        jbert.bert_tiny(**NO_DROPOUT), num_classes=3, dropout=0.0), seed=1)
    tm = tbert.BertForSequenceClassification(
        tbert.bert_tiny(device="cpu", **NO_DROPOUT), num_classes=3,
        dropout=0.0)
    convert.load_paddle_tpu_state(tm, _np_state(jm))
    _close(tm(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask)),
           jm(paddle.to_tensor(ids), attention_mask=paddle.to_tensor(mask)),
           "bert classifier logits")
    je = _seeded(lambda: jernie.ErnieForSequenceClassification(
        jernie.ernie_tiny(**NO_DROPOUT), num_classes=3), seed=2)
    te = ternie.ErnieForSequenceClassification(
        ternie.ernie_tiny(device="cpu", **NO_DROPOUT), num_classes=3)
    convert.load_paddle_tpu_state(te, _np_state(je))
    jlog, tlog = je(paddle.to_tensor(ids)), te(torch.from_numpy(ids))
    _close(tlog, jlog, "ernie logits")
    jlog.sum().backward()
    tlog.sum().backward()
    _check_grads(je, te)


def test_three_adamw_steps_through_train_step_match_the_reference_loop():
    jm, tm = _pretraining_pair()
    jcrit, tcrit = jbert.BertPretrainingCriterion(V), \
        tbert.BertPretrainingCriterion(V)
    jopt = paddle.optimizer.AdamW(learning_rate=LR,
                                  parameters=jm.parameters())
    opt = topt.AdamW(learning_rate=LR, parameters=tm.parameters())

    def step_fn(ids, nsp):
        scores, rel = tm(ids)
        loss = tcrit(scores, rel, ids, nsp)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    train = tjit.TrainStep(step_fn, tm, opt)
    ids, _, nsp = _batch(seed=4)
    grads = {}
    for step in range(3):
        scores, rel = jm(paddle.to_tensor(ids))
        jloss = jcrit(scores, rel, paddle.to_tensor(ids),
                      paddle.to_tensor(nsp))
        jloss.backward()
        grads = {n: np.asarray(p.grad.numpy())
                 for n, p in jm.named_parameters()}
        jopt.step()
        jopt.clear_grad()
        tloss = train(torch.from_numpy(ids), torch.from_numpy(nsp))
        _close(tloss, jloss, f"loss at step {step}")
    linear = _linear_names(jm)
    got = dict(tm.named_parameters())
    for name, p in jm.named_parameters():
        want, g = np.asarray(p.numpy()), grads[name]
        if name in linear:
            want, g = want.T, g.T
        live = np.abs(g) > 1e-6
        np.testing.assert_allclose(got[name].detach().numpy()[live],
                                   want[live], **TOL, err_msg=name)


def test_dropout_masks_follow_the_models_generator():
    cfg = dict(vocab_size=V, hidden_dropout_prob=0.2,
               attention_probs_dropout_prob=0.2)
    ids, _, nsp = _batch(seed=5)
    crit = tbert.BertPretrainingCriterion(V)

    def losses(seed):
        m = tbert.BertForPretraining(tbert.bert_tiny(
            device="cpu", generator=torch.Generator().manual_seed(seed),
            **cfg))
        with torch.no_grad():
            return [float(crit(*m(torch.from_numpy(ids)),
                               torch.from_numpy(ids), torch.from_numpy(nsp)))
                    for _ in range(2)]

    a, b = losses(7), losses(7)
    assert a == b  # weights and masks from the generator alone
    assert a[0] != a[1]  # a new key every forward
    m = tbert.bert_tiny(device="cpu", **cfg)
    # every dropout layer of the model has its own site of one stream
    sites = [d.site for d in m.dropout_keys.layers]
    assert sites == list(range(len(sites))) and len(sites) == 1 + 4 * 2
    m.eval()
    with torch.no_grad():
        x = m(torch.from_numpy(ids))[0]
        assert torch.equal(x, m(torch.from_numpy(ids))[0])


def test_convert_round_trips_both_ways(pretraining_pair):
    jm, tm = pretraining_pair
    tm = copy.deepcopy(tm)  # its weights move below
    ids, _, _ = _batch(seed=6)
    back = convert.state_to_paddle_tpu(tm)
    ref = _np_state(jm)
    assert sorted(back) == sorted(ref)  # the tied weight under one name
    for k, v in ref.items():
        np.testing.assert_array_equal(back[k].detach().numpy(), v, err_msg=k)
    # port -> reference: the port's trained state into a fresh reference
    with torch.no_grad():
        for p in tm.parameters():
            p.add_(0.01)
    fresh = _seeded(lambda: jbert.BertForPretraining(
        jbert.bert_tiny(**NO_DROPOUT)), seed=9)
    fresh.set_state_dict({k: paddle.to_tensor(v.detach().numpy())
                          for k, v in convert.state_to_paddle_tpu(tm).items()})
    with torch.no_grad():
        want = tm(torch.from_numpy(ids))[0]
    _close(want, fresh(paddle.to_tensor(ids))[0],
           "port state in the reference")
    # the fused layer's packed qkv_proj, both ways
    jf = _seeded(lambda: jinc.FusedTransformerEncoderLayer(128, 2, 512, 0.0))
    tf = tinc.FusedTransformerEncoderLayer(128, 2, 512, 0.0)
    convert.load_paddle_tpu_state(tf, _np_state(jf))
    x = np.random.default_rng(7).standard_normal((B, T, 128)).astype(
        np.float32)  # the encoder's shapes
    _close(tf(torch.from_numpy(x)), jf(paddle.to_tensor(x)), "fused layer")
    for k, v in _np_state(jf).items():
        np.testing.assert_array_equal(
            convert.state_to_paddle_tpu(tf)[k].detach().numpy(), v)


def test_a_wrapped_trunks_state_loads_without_its_prefix():
    jm = _seeded(lambda: jernie.ErnieForSequenceClassification(
        jernie.ernie_tiny(**NO_DROPOUT)))
    te = ternie.ernie_tiny(device="cpu", **NO_DROPOUT)
    state = {k: v for k, v in _np_state(jm).items()
             if k.startswith("ernie.")}
    convert.load_paddle_tpu_state(te, state)
    np.testing.assert_array_equal(
        te.pooler.dense.weight.detach().numpy(),
        state["ernie.pooler.dense.weight"].T)


def test_static_program_and_a_cuda_route_on_the_cpu_refuse():
    # the static Program is ported (tests/test_torch_static.py holds it
    # against the reference): recording the model no longer refuses
    te = ternie.ernie_tiny(device="cpu", **NO_DROPOUT)
    prog, feeds, fetch = ternie.build_static_inference_program(te,
                                                               seq_len=T)
    assert feeds == ["input_ids"] and fetch.static_shape == [-1, 128]
    with pytest.raises(ValueError, match="CUDA device"):
        tbert.bert_tiny(device="cpu", attn_kernel="cuda")
