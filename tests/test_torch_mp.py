"""Tensor parallelism of the port against the JAX package: the mp
primitives (``meta_parallel.mp_ops``), the mp layers, the named random
streams, and ``gpt2-tiny`` trained at dp 2 x mp 2.

Every rank is a process of one gloo world per size (2 and 4 ranks, built
once for the module by ``testing.world.World``; the ranks import torch
and the port only). The reference computes the same function on the
whole arrays (its mp forms are layouts of global arrays, or shard-local
inside ``shard_map``); rank ``r`` of the port holds its mp shard and must
reproduce the reference's values. Tolerances, float32 throughout: the
primitives and layers 1e-5 (sums over ranks in another order); the GPT
leg's losses over 4 AdamW steps and its merged parameters 1e-5, as the
issue sets them; the same leg with q, k and v split as one contiguous
block of columns (not head by head) must miss the reference by more.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.distributed import collective as jcoll  # noqa: E402
from paddle_tpu.distributed import fleet as jfleet  # noqa: E402
from paddle_tpu.distributed import spmd as jspmd  # noqa: E402
from paddle_tpu.distributed.meta_parallel import mp_ops as jmp  # noqa: E402
from paddle_tpu.models import gpt as jgpt  # noqa: E402
from paddle_tpu_torch.testing.world import World  # noqa: E402

# one intra-op thread: the suite's parallel workers share the CPU, and
# a torch thread pool in each would oversubscribe it
torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    made = {}
    mesh, groups = jcoll._global_mesh, dict(jcoll._groups)
    fleet_state = dict(jfleet._fleet_state)

    def get(n):
        if n not in made:
            made[n] = World(n, tmp_path_factory.mktemp(f"world{n}"),
                            timeout=60)
        return made[n]

    yield get
    for w in made.values():
        w.close()
    jspmd.disable()
    jcoll._global_mesh = mesh
    jcoll._groups.clear()
    jcoll._groups.update(groups)
    jfleet._fleet_state.clear()
    jfleet._fleet_state.update(fleet_state)


def _fleet(dp, mp):
    """Rank side: ``fleet.init`` at ``dp x mp``; returns the mp group."""
    from paddle_tpu_torch.distributed import fleet

    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": mp}
    fleet.init(is_collective=True, strategy=s)
    return fleet.get_hybrid_communicate_group().get_model_parallel_group()


def _cols(a, g, axis=-1):
    """Rank ``g.rank``'s chunk of ``a`` along ``axis`` (numpy)."""
    return np.split(a, g.nranks, axis=axis)[g.rank]


# ------------------------------------------------------- the primitives ---
def _rank_ce(logits, labels, ignore_index):
    import torch
    from paddle_tpu_torch.distributed.meta_parallel import mp_ops

    g = _fleet(1, _world())
    lg = torch.from_numpy(_cols(logits, g).copy()).requires_grad_()
    loss = mp_ops._c_softmax_with_cross_entropy(
        lg, torch.from_numpy(labels), ignore_index=ignore_index)
    loss.sum().backward()
    return loss.detach().numpy(), lg.grad.numpy()


def _world():
    from paddle_tpu_torch.distributed import get_world_size

    return get_world_size()


@pytest.mark.parametrize("ignore_index", [-100, 3])
@pytest.mark.parametrize("n", [2, 4])
def test_sharded_softmax_ce_and_its_gradient_match_the_reference(
        worlds, n, ignore_index):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 8, 32)).astype(np.float32)
    labels = rng.integers(0, 32, (2, 8))
    labels[0, :3] = 3

    def ref(lg):
        return jmp._c_softmax_with_cross_entropy(
            lg, jnp.asarray(labels), ignore_index=ignore_index)

    want = np.asarray(ref(jnp.asarray(logits)))
    gwant = np.asarray(jax.grad(lambda lg: ref(lg).sum())(
        jnp.asarray(logits)))
    for r, (loss, grad) in enumerate(worlds(n).run(
            _rank_ce, logits, labels, ignore_index)):
        np.testing.assert_allclose(loss, want, **TOL)
        np.testing.assert_allclose(grad, np.split(gwant, n, -1)[r], **TOL)
    if ignore_index == 3:
        assert (want[labels == 3] == 0).all()


def _rank_lookup(table, ids):
    import torch
    from paddle_tpu_torch.distributed.meta_parallel import mp_ops

    g = _fleet(1, _world())
    t = torch.from_numpy(_cols(table, g, axis=0).copy()).requires_grad_()
    out = mp_ops._c_lookup_table(t, torch.from_numpy(ids))
    (out * torch.arange(out.shape[-1])).sum().backward()
    return out.detach().numpy(), t.grad.numpy()


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_lookup_and_its_gradient_match_dense(worlds, n):
    rng = np.random.default_rng(2)
    table = rng.standard_normal((40, 16)).astype(np.float32)
    ids = rng.integers(0, 40, (3, 7))
    want = np.asarray(jmp._c_lookup_table(jnp.asarray(table),
                                          jnp.asarray(ids)))
    gwant = np.asarray(jax.grad(lambda t: (jmp._c_lookup_table(
        t, jnp.asarray(ids)) * jnp.arange(16)).sum())(jnp.asarray(table)))
    for r, (out, grad) in enumerate(worlds(n).run(_rank_lookup, table, ids)):
        np.testing.assert_allclose(out, want, **TOL)
        np.testing.assert_allclose(grad, np.split(gwant, n, 0)[r], **TOL)


def _rank_pairs(x):
    import torch
    from paddle_tpu_torch.distributed.meta_parallel import mp_ops

    g = _fleet(1, _world())
    out = {}
    for name in ("_mp_allreduce", "_c_identity"):
        v = torch.from_numpy(x[g.rank:g.rank + 1].copy()).requires_grad_()
        y = getattr(mp_ops, name)(v)
        y.sum().backward()
        out[name] = (y.detach().numpy(), v.grad.numpy())
    v = torch.from_numpy(x.copy()).requires_grad_()
    piece = mp_ops._c_split(v)
    back = mp_ops._c_concat(piece)
    (back * torch.arange(1.0, back.numel() + 1).view(back.shape)).sum() \
        .backward()
    out["split_concat"] = (piece.detach().numpy(), back.detach().numpy(),
                           v.grad.numpy())
    return out


@pytest.mark.parametrize("n", [2, 4])
def test_identity_allreduce_split_concat_and_their_vjps(worlds, n):
    # f/g pairs: _mp_allreduce sums forward and passes the gradient; the
    # identity passes forward and sums the gradient; split keeps a chunk
    # and concat gathers it back, each the other's gradient
    mesh = Mesh(np.array(jax.devices()[:n]), ("mp",))
    x = np.arange(float(n * 4), dtype=np.float32).reshape(n, 4)

    def sm(f):
        return jax.shard_map(f, mesh=mesh, in_specs=P("mp"),
                             out_specs=P("mp"), check_vma=False)

    ar = np.asarray(sm(lambda s: jmp._mp_allreduce(s, axis="mp"))(x))
    ar_g = np.asarray(jax.grad(lambda v: sm(
        lambda s: jmp._mp_allreduce(s, axis="mp"))(v).sum())(x))
    id_g = np.asarray(jax.grad(lambda v: sm(
        lambda s: jmp._c_identity(s, axis="mp"))(v).sum())(x))
    rt = np.asarray(jax.shard_map(
        lambda v: jmp._c_concat(jmp._c_split(v)), mesh=mesh, in_specs=P(),
        out_specs=P(), check_vma=False)(x))
    for r, got in enumerate(worlds(n).run(_rank_pairs, x)):
        y, g = got["_mp_allreduce"]
        np.testing.assert_allclose(y, ar[r:r + 1], **TOL)
        np.testing.assert_allclose(g, ar_g[r:r + 1], **TOL)
        y, g = got["_c_identity"]
        np.testing.assert_allclose(y, x[r:r + 1], **TOL)
        np.testing.assert_allclose(g, id_g[r:r + 1], **TOL)  # n each
        piece, back, g = got["split_concat"]
        np.testing.assert_allclose(piece, np.split(x, n, -1)[r], **TOL)
        np.testing.assert_allclose(back, rt, **TOL)
        # concat's gradient is this rank's chunk, which split's gradient
        # gathers back: every rank's x receives the whole gradient
        np.testing.assert_allclose(
            g, np.arange(1.0, x.size + 1).reshape(x.shape), **TOL)


# ----------------------------------------------------------- the layers ---
def _rank_layers(w1, b1, w2, b2, x, table, ids, logits, labels):
    import torch
    from paddle_tpu_torch.distributed import spmd
    from paddle_tpu_torch.distributed.meta_parallel import (
        ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
        VocabParallelEmbedding)

    g = _fleet(1, _world())
    n, r = g.nranks, g.rank
    col = ColumnParallelLinear(16, 24, gather_output=False)
    row = RowParallelLinear(24, 16, input_is_parallel=True)
    with torch.no_grad():
        col.weight.copy_(spmd.local_shard(torch.from_numpy(w1.T), 0, r, n))
        col.bias.copy_(spmd.local_shard(torch.from_numpy(b1), 0, r, n))
        row.weight.copy_(spmd.local_shard(torch.from_numpy(w2.T), 1, r, n))
        row.bias.copy_(torch.from_numpy(b2))
    xt = torch.from_numpy(x).requires_grad_()
    y = row(col(xt))
    (y * y).mean().backward()
    gathered = ColumnParallelLinear(16, 24, gather_output=True)
    with torch.no_grad():
        gathered.weight.copy_(col.weight)
        gathered.bias.copy_(col.bias)
    emb = VocabParallelEmbedding(64, 8)
    with torch.no_grad():
        emb.weight.copy_(spmd.local_shard(torch.from_numpy(table), 0, r, n))
    lg = torch.from_numpy(_cols(logits, g).copy()).requires_grad_()
    ce = ParallelCrossEntropy()(lg, torch.from_numpy(labels))
    ce.sum().backward()
    return {"y": y.detach().numpy(), "x_grad": xt.grad.numpy(),
            "w1_grad": col.weight.grad.numpy(),
            "w2_grad": row.weight.grad.numpy(),
            "b2_grad": row.bias.grad.numpy(),
            "gathered": gathered(torch.from_numpy(x)).detach().numpy(),
            "emb": emb(torch.from_numpy(ids)).detach().numpy(),
            "ce": ce.detach().numpy(), "ce_grad": lg.grad.numpy()}


@pytest.mark.parametrize("n", [2, 4])
def test_column_row_vocab_and_parallel_ce_match_dense_layers(worlds, n):
    rng = np.random.default_rng(7)
    paddle.seed(7)
    ref1, ref2 = paddle.nn.Linear(16, 24), paddle.nn.Linear(24, 16)
    w1, b1 = (np.asarray(p.numpy()) for p in (ref1.weight, ref1.bias))
    w2, b2 = (np.asarray(p.numpy()) for p in (ref2.weight, ref2.bias))
    x = rng.standard_normal((4, 16)).astype(np.float32)
    xj = paddle.to_tensor(x)
    xj.stop_gradient = False
    y = ref2(ref1(xj))
    (y * y).mean().backward()
    table = rng.standard_normal((64, 8)).astype(np.float32)
    ids = rng.integers(0, 64, (3, 5))
    logits = rng.standard_normal((2, 6, 32)).astype(np.float32)
    labels = rng.integers(0, 32, (2, 6))
    lj = paddle.to_tensor(logits)
    lj.stop_gradient = False
    ce = paddle.nn.functional.cross_entropy(lj, paddle.to_tensor(labels),
                                            reduction="none")
    ce.sum().backward()
    got = worlds(n).run(_rank_layers, w1, b1, w2, b2, x, table, ids, logits,
                        labels)
    for r, res in enumerate(got):
        np.testing.assert_allclose(res["y"], np.asarray(y.numpy()), **TOL)
        np.testing.assert_allclose(res["x_grad"], np.asarray(
            xj.grad.numpy()), **TOL)
        np.testing.assert_allclose(res["w1_grad"], np.split(np.asarray(
            ref1.weight.grad.numpy()).T, n, 0)[r], **TOL)
        np.testing.assert_allclose(res["w2_grad"], np.split(np.asarray(
            ref2.weight.grad.numpy()).T, n, 1)[r], **TOL)
        np.testing.assert_allclose(res["b2_grad"], np.asarray(
            ref2.bias.grad.numpy()), **TOL)
        np.testing.assert_allclose(res["gathered"], x @ w1 + b1, **TOL)
        np.testing.assert_allclose(res["emb"], table[ids], **TOL)
        np.testing.assert_allclose(res["ce"][..., 0],
                                   np.asarray(ce.numpy()).reshape(2, 6),
                                   **TOL)
        np.testing.assert_allclose(res["ce_grad"], np.split(np.asarray(
            lj.grad.numpy()), n, -1)[r], **TOL)


def _rank_rng():
    import torch
    from paddle_tpu_torch.distributed.meta_parallel import (
        get_rng_state_tracker, model_parallel_random_seed)

    _fleet(1, _world())
    model_parallel_random_seed(5)
    with get_rng_state_tracker().rng_state():
        local = torch.rand(4)
    shared = torch.rand(4)
    with get_rng_state_tracker().rng_state():
        local2 = torch.rand(4)
    return local.numpy(), local2.numpy(), shared.numpy()


@pytest.mark.parametrize("n", [2, 4])
def test_model_parallel_streams_differ_by_rank_the_shared_one_does_not(
        worlds, n):
    got = worlds(n).run(_rank_rng)
    locals_ = [g[0] for g in got]
    assert all(not np.array_equal(locals_[0], a) for a in locals_[1:])
    for local, local2, shared in got:
        assert not np.array_equal(local, local2)  # the stream advanced
        np.testing.assert_array_equal(shared, got[0][2])
        np.testing.assert_array_equal(
            shared, torch.rand(4, generator=torch.Generator().manual_seed(5)))


# ---------------------------------------------------- gpt2-tiny, dp x mp --
V, T, B, DP, MP, STEPS = 64, 16, 16, 2, 2, 4
GPT_CFG = dict(vocab_size=V, n_layer=2, seq_len=T, dropout=0.0, n_head=2,
               d_model=32)


def _batch():
    toks = np.random.default_rng(0).integers(0, V, (B, T)).astype(np.int64)
    return toks, np.roll(toks, -1, 1)


@pytest.fixture(scope="module")
def reference_leg():
    """The reference's dp 2 x mp 2 leg (``tests/test_spmd.py``'s shape):
    ``fleet.distributed_model`` on the SPMD mesh and ``spmd.shard_batch``,
    AdamW(1e-3), 4 eager steps. Initial state, losses, final state."""
    state = paddle.get_rng_state()
    try:
        s = jfleet.DistributedStrategy()
        s.hybrid_configs = {"dp_degree": DP, "mp_degree": MP,
                            "pp_degree": 1, "sharding_degree": 1,
                            "use_spmd": True}
        jfleet.init(is_collective=True, strategy=s)
        paddle.seed(123)
        model = jgpt.GPTForPretraining(jgpt.GPTModel(
            jgpt.GPTConfig.preset("gpt2-tiny", **GPT_CFG)))
        init = {k: np.asarray(v.numpy())
                for k, v in model.state_dict().items()}
        model = jfleet.distributed_model(model)
        opt = paddle.optimizer.AdamW(1e-3, parameters=model.parameters())
        crit = jgpt.GPTPretrainingCriterion()
        toks, labels = _batch()
        toks = jspmd.shard_batch(paddle.to_tensor(toks))
        labels = jspmd.shard_batch(paddle.to_tensor(labels))
        losses = []
        for _ in range(STEPS):
            loss = crit(model(toks), labels)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
        final = {k: np.asarray(v.numpy())
                 for k, v in model.state_dict().items()}
    finally:
        jspmd.disable()
        paddle.set_rng_state(state)
    return init, losses, final


def _rank_gpt(init, contiguous_qkv):
    import torch
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import collective, fleet, spmd
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.optimizer import AdamW

    _fleet(DP, MP)
    model = gpt.GPTForPretraining(gpt.GPTModel(
        gpt.GPTConfig.preset("gpt2-tiny", **GPT_CFG), device="cpu"))
    if contiguous_qkv:  # the wrong split: q, k and v as one block
        for blk in model.gpt.blocks:
            for p in (blk.attn.qkv_proj.weight, blk.attn.qkv_proj.bias):
                p.shard_layout = (1, 1)
    fleet.distributed_model(model)
    convert.load_paddle_tpu_state(model, init)  # the full state, sliced
    heads = {blk.attn.qkv_proj.weight.shape[0] // (3 * blk.attn.head_dim)
             for blk in model.gpt.blocks}
    opt = AdamW(1e-3, parameters=model.parameters())
    crit = gpt.GPTPretrainingCriterion()
    toks, labels = (spmd.shard_batch(torch.from_numpy(a)) for a in _batch())
    dp = fleet.get_hybrid_communicate_group().get_data_parallel_group()
    losses = []
    for _ in range(STEPS):
        loss = crit(model(toks), labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        mean = loss.detach().clone()
        collective.all_reduce(mean, collective.ReduceOp.AVG, group=dp)
        losses.append(float(mean))
    merged = convert.merged_state_to_paddle_tpu(model)
    return (losses, {k: v.numpy() for k, v in merged.items()},
            sorted(heads), tuple(toks.shape))


def test_gpt_dp2_mp2_matches_the_reference_spmd_leg(worlds, reference_leg):
    init, losses, final = reference_leg
    got = worlds(DP * MP).run(_rank_gpt, init, False)
    for r, (r_losses, merged, heads, shape) in enumerate(got):
        assert heads == [GPT_CFG["n_head"] // MP]
        assert shape == (B // DP, T)
        np.testing.assert_allclose(r_losses, losses, **TOL)
        assert sorted(merged) == sorted(final)
        for k, v in final.items():
            np.testing.assert_allclose(merged[k], v, **TOL, err_msg=k)
    # the check has teeth: a contiguous split of the fused qkv columns
    # (a contiguous third of q, k and v each, not whole heads) trains,
    # and misses the reference
    wrong = worlds(DP * MP).run(_rank_gpt, init, True)
    assert np.isfinite(wrong[0][0]).all()
    gap = np.abs(np.asarray(wrong[0][0]) - np.asarray(losses)).max()
    assert gap > 100 * TOL["atol"], gap


def _rank_hapi_gpt(init):
    """The same leg through ``hapi.Model`` in a Paddle user's order: the
    optimizer through ``fleet.distributed_optimizer``, then ``prepare``
    and ``train_batch`` (which shards the network on its first batch)."""
    from paddle_tpu_torch import convert, hapi
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.optimizer import AdamW

    _fleet(DP, MP)
    net = gpt.GPTForPretraining(gpt.GPTModel(
        gpt.GPTConfig.preset("gpt2-tiny", **GPT_CFG), device="cpu"))
    convert.load_paddle_tpu_state(net, init)
    opt = fleet.distributed_optimizer(
        AdamW(1e-3, parameters=net.parameters()))
    model = hapi.Model(net)
    model.prepare(optimizer=opt, loss=gpt.GPTPretrainingCriterion())
    toks, labels = _batch()
    losses = [model.train_batch([toks], [labels])[0] for _ in range(STEPS)]
    heads = {blk.attn.qkv_proj.weight.shape[0] // (3 * blk.attn.head_dim)
             for blk in net.gpt.blocks}
    merged = convert.merged_state_to_paddle_tpu(net)
    return losses, {k: v.numpy() for k, v in merged.items()}, sorted(heads)


def test_hapi_dp2_mp2_after_distributed_optimizer_matches_the_reference(
        worlds, reference_leg):
    init, losses, final = reference_leg
    for r_losses, merged, heads in worlds(DP * MP).run(_rank_hapi_gpt,
                                                       init):
        assert heads == [GPT_CFG["n_head"] // MP]
        np.testing.assert_allclose(r_losses, losses, **TOL)
        assert sorted(merged) == sorted(final)
        for k, v in final.items():
            np.testing.assert_allclose(merged[k], v, **TOL, err_msg=k)


DROP_CFG = dict(GPT_CFG, dropout=0.1, attn_dropout=0.1)


def _dropout_run(model, toks, labels, step_fn):
    """``STEPS`` SGD(0.1) steps of ``model`` with its dropout sites' masks
    (attention output of layer 0, whole) and block 0's output recorded in
    the first forward. ``step_fn(loss) -> float``. SGD, not Adam: Adam's
    normalised step turns the sum order's rounding of a gradient near 0
    (many are, under dropout) into a step of the learning rate's size."""
    import torch
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.optimizer import SGD

    seen = {}
    real = gpt.hashed_dropout

    def recording(y, p, key, site, *shard):
        out = real(y, p, key, site, *shard)
        seen.setdefault(site, (out != 0).numpy())
        return out

    def keep_block0(mod, args, out):
        seen.setdefault("block0", out.detach().numpy())

    hook = model.gpt.blocks[0].register_forward_hook(keep_block0)
    opt = SGD(0.1, parameters=model.parameters())
    crit = gpt.GPTPretrainingCriterion()
    losses = []
    gpt.hashed_dropout = recording
    try:
        for _ in range(STEPS):
            loss = crit(model(toks), labels)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(step_fn(loss.detach()))
    finally:
        gpt.hashed_dropout = real
        hook.remove()
    return losses, seen[0], seen["block0"]


def _rank_gpt_dropout(init):
    import torch
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import collective, fleet, get_rank, spmd
    from paddle_tpu_torch.models import gpt

    _fleet(DP, MP)
    # every rank's generator differs: distributed_model makes them rank 0's
    model = gpt.GPTForPretraining(gpt.GPTModel(
        gpt.GPTConfig.preset("gpt2-tiny", **DROP_CFG), device="cpu",
        generator=torch.Generator().manual_seed(7 + get_rank())))
    fleet.distributed_model(model)
    convert.load_paddle_tpu_state(model, init)
    toks, labels = (spmd.shard_batch(torch.from_numpy(a)) for a in _batch())
    dp = fleet.get_hybrid_communicate_group().get_data_parallel_group()

    def mean(loss):
        collective.all_reduce(loss, collective.ReduceOp.AVG, group=dp)
        return float(loss)

    losses, attn_mask, block0 = _dropout_run(model, toks, labels, mean)
    merged = convert.merged_state_to_paddle_tpu(model)
    return (losses, {k: v.numpy() for k, v in merged.items()}, attn_mask,
            block0)


def test_gpt_dp2_mp2_dropout_masks_are_the_whole_batch_ones(
        worlds, reference_leg):
    # dropout 0.1 everywhere: each rank hashes its elements' indices in the
    # whole array, so its heads inside the column-parallel region draw
    # their own mask (unlike its mp peer's), the replicated residual stream
    # stays bitwise equal across the mp ranks, and the run equals one
    # process over the whole batch with rank 0's generator (float32 1e-5)
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.models import gpt

    init = reference_leg[0]
    got = worlds(DP * MP).run(_rank_gpt_dropout, init)
    one = gpt.GPTForPretraining(gpt.GPTModel(
        gpt.GPTConfig.preset("gpt2-tiny", **DROP_CFG), device="cpu",
        generator=torch.Generator().manual_seed(7)))
    convert.load_paddle_tpu_state(one, init)
    toks, labels = (torch.from_numpy(a) for a in _batch())
    losses, attn_mask, block0 = _dropout_run(one, toks, labels, float)
    assert 0.85 < attn_mask.mean() < 0.95
    # ranks are (dp, mp) = (0, 0), (0, 1), (1, 0), (1, 1)
    for d in range(DP):
        (_, _, m0, b0), (_, _, m1, b1) = got[d * MP:(d + 1) * MP]
        assert not np.array_equal(m0, m1)
        np.testing.assert_array_equal(b0, b1)
    whole = np.concatenate([np.concatenate([g[2] for g in got[d * MP:(
        d + 1) * MP]], -1) for d in range(DP)], 0)
    np.testing.assert_array_equal(whole, attn_mask)
    np.testing.assert_allclose(
        np.concatenate([got[d * MP][3] for d in range(DP)], 0), block0,
        **TOL)
    want = {k: v.numpy() for k, v in convert.state_to_paddle_tpu(
        one).items()}
    for r_losses, merged, _, _ in got:
        np.testing.assert_allclose(r_losses, losses, **TOL)
        for k, v in want.items():
            np.testing.assert_allclose(merged[k], v, **TOL, err_msg=k)


def _rank_data_parallel(x, y, w):
    import torch
    from paddle_tpu_torch.distributed import DataParallel, get_rank

    _fleet(_world(), 1)
    lin = torch.nn.Linear(4, 1, bias=False)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w))
    dp = DataParallel(lin)
    r, n = get_rank(), _world()
    k = x.shape[0] // n
    pred = dp(torch.from_numpy(x[r * k:(r + 1) * k]))
    loss = dp.scale_loss(((pred - torch.from_numpy(y[r * k:(r + 1) * k]))
                          ** 2).mean())
    loss.backward()
    after_backward = lin.weight.grad.clone()
    dp.apply_collective_grads()  # nothing left to average
    return after_backward.numpy(), lin.weight.grad.numpy()


@pytest.mark.parametrize("n", [2, 4])
def test_data_parallel_averages_to_the_whole_batch_gradient(worlds, n):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, 4)).astype(np.float32)
    y = rng.standard_normal((8, 1)).astype(np.float32)
    w = rng.standard_normal((1, 4)).astype(np.float32)
    want = 2 * ((x @ w.T - y) * x).mean(0, keepdims=True)
    for after_backward, after_apply in worlds(n).run(
            _rank_data_parallel, x, y, w):
        np.testing.assert_allclose(after_backward, want, **TOL)
        np.testing.assert_array_equal(after_apply, after_backward)
