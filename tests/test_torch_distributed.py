"""The port's process group, collectives, store, fleet topology and metrics,
and the callers that wait for them, against the JAX package.

The reference is one controller over eight virtual CPU devices: its
eager collectives take a global array whose leading dim spans the group.
The port runs one process per rank, so rank ``r`` of a group holds row
block ``r`` of the reference's input and must get row block ``r`` of the
reference's result. One gloo world per size (2 and 4 ranks) serves the
whole module (``testing.world.World``: ``file://`` rendezvous, every wait
with a 60 s deadline; a failed or hung case fails alone and the next one
starts a fresh world). The ranks import torch and the port only.
Tolerances: float32 collectives reduce in another order, 1e-6; the GPT
``fit`` leg 1e-5 (float32, summed in another order).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import hapi as jhapi  # noqa: E402
from paddle_tpu import io as jio  # noqa: E402
from paddle_tpu.distributed import collective as jcoll  # noqa: E402
from paddle_tpu.distributed import fleet as jfleet  # noqa: E402
from paddle_tpu.distributed import spmd as jspmd  # noqa: E402
from paddle_tpu.distributed.fleet import metrics as jmetrics  # noqa: E402
from paddle_tpu.distributed.fleet import topology as jtopo  # noqa: E402
from paddle_tpu.distributed.store import TCPStore as JStore  # noqa: E402
from paddle_tpu.incubate import checkpoint as jckpt  # noqa: E402
from paddle_tpu.models import gpt as jgpt  # noqa: E402
from paddle_tpu_torch import convert  # noqa: E402
from paddle_tpu_torch.distributed import store as tstore  # noqa: E402
from paddle_tpu_torch.distributed.fleet import topology as ttopo  # noqa: E402
from paddle_tpu_torch.profiler import registry  # noqa: E402
from paddle_tpu_torch.testing import faults as tfaults  # noqa: E402
from paddle_tpu_torch.testing.world import World  # noqa: E402

# one intra-op thread: the suite's parallel workers share the CPU, and
# a torch thread pool in each would oversubscribe it
torch.set_num_threads(1)

TOL = dict(atol=1e-6, rtol=1e-6)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """``worlds(n)``: this module's world of ``n`` gloo ranks."""
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
    # the reference's mesh and fleet state are process-global
    jspmd.disable()
    jcoll._global_mesh = mesh
    jcoll._groups.clear()
    jcoll._groups.update(groups)
    jfleet._fleet_state.clear()
    jfleet._fleet_state.update(fleet_state)


# ------------------------------------------------------------ collectives --
GROUPS = {"world2": (2, [0, 1]), "world4": (4, [0, 1, 2, 3]),
          "ranks_1_3_of_4": (4, [1, 3])}
OPS = ["all_reduce:SUM", "all_reduce:MAX", "all_reduce:MIN",
       "all_reduce:AVG", "reduce", "broadcast", "all_gather",
       "reduce_scatter", "scatter", "alltoall"]


def _data(n, op, seed=0):
    rng = np.random.default_rng(seed)
    if op == "all_reduce:PROD":
        return rng.uniform(0.5, 1.5, (2 * n, 3)).astype(np.float32)
    # the reference's all_gather splits its input only when the leading
    # dim is the group's size: one row per rank
    rows = n if op == "all_gather" else 2 * n
    return rng.standard_normal((rows, 4)).astype(np.float32)


def _rank_collective(op, data, ranks):
    """The port's side: every rank makes the group; a member runs ``op``
    on its row block and returns its result."""
    import torch
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import get_rank

    g = C.new_group(ranks)
    if get_rank() not in ranks:
        return None
    i, n = g.rank, g.nranks
    k = data.shape[0] // n
    mine = torch.from_numpy(data[i * k:(i + 1) * k].copy())
    name, _, red = op.partition(":")
    if name == "all_reduce":
        C.all_reduce(mine, op=getattr(C.ReduceOp, red), group=g)
        return mine.numpy()
    if name == "reduce":
        C.reduce(mine, dst=ranks[0], group=g)
        return mine.numpy()
    if name == "broadcast":
        C.broadcast(mine, src=ranks[-1], group=g)
        return mine.numpy()
    if name == "all_gather":
        out = []
        C.all_gather(out, mine, group=g)
        return np.stack([t.numpy() for t in out])
    if name == "reduce_scatter":
        flat = mine.reshape(-1)
        out = torch.empty(flat.numel() // n)
        C.reduce_scatter(out, flat, group=g)
        return out.numpy()
    if name == "scatter":
        out = torch.empty(4)
        src = [torch.from_numpy(data[j].copy()) for j in range(n)] \
            if i == 0 else None
        C.scatter(out, src, src=ranks[0], group=g)
        return out.numpy()
    if name == "alltoall":
        flat = mine.reshape(-1)
        rows = []
        out = C.alltoall(flat, rows, group=g)
        assert torch.equal(torch.stack(rows), out)
        return out.numpy()
    raise ValueError(op)


def _reference(op, data, ranks):
    """The reference's eager result (a global array over the group)."""
    g = jcoll.new_group(ranks)
    name, _, red = op.partition(":")
    x = paddle.to_tensor(data)
    if name == "all_reduce":
        jcoll.all_reduce(x, op=getattr(jcoll.ReduceOp, red), group=g)
        return np.asarray(x.numpy())
    if name == "reduce":
        jcoll.reduce(x, dst=ranks[0], group=g)
        return np.asarray(x.numpy())
    if name == "broadcast":
        jcoll.broadcast(x, src=ranks[-1], group=g)
        return np.asarray(x.numpy())
    if name == "all_gather":
        out = []
        jcoll.all_gather(out, x, group=g)
        return np.stack([np.asarray(t.numpy()) for t in out])
    if name == "reduce_scatter":
        out = paddle.to_tensor(np.zeros(data.size // len(ranks), np.float32))
        jcoll.reduce_scatter(out, paddle.to_tensor(data.reshape(-1)),
                             group=g)
        return np.asarray(out.numpy())
    if name == "scatter":
        out = paddle.to_tensor(np.zeros((len(ranks), 4), np.float32))
        jcoll.scatter(out, [paddle.to_tensor(data[:len(ranks)])], src=0,
                      group=g)
        return np.asarray(out.numpy())
    if name == "alltoall":
        out = []
        jcoll.alltoall(paddle.to_tensor(data.reshape(-1)), out, group=g)
        return np.asarray([np.asarray(o.numpy()) for o in out])
    raise ValueError(op)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("where", list(GROUPS))
def test_collective_rank_gets_its_row_of_the_reference(worlds, where, op):
    n, ranks = GROUPS[where]
    data = _data(len(ranks), op)
    got = worlds(n).run(_rank_collective, op, data, ranks)
    want = _reference(op, data, ranks)
    m = len(ranks)
    for r in range(n):
        if r not in ranks:
            assert got[r] is None
            continue
        i = ranks.index(r)
        if op == "all_gather":
            # the reference's list holds each rank's block; every rank
            # gets the whole list
            np.testing.assert_allclose(got[r], want, **TOL)
        elif op == "scatter":
            np.testing.assert_allclose(got[r], want[i], **TOL)
        else:
            k = want.shape[0] // m
            np.testing.assert_allclose(got[r], want[i * k:(i + 1) * k],
                                       **TOL)


@pytest.mark.parametrize("where", list(GROUPS))
def test_all_reduce_prod_multiplies_where_the_reference_sums(worlds, where):
    # the reference's fault, which the port does not copy: it has no
    # product reducer and sums for ReduceOp.PROD
    n, ranks = GROUPS[where]
    op = "all_reduce:PROD"
    data = _data(len(ranks), op)
    got = worlds(n).run(_rank_collective, op, data, ranks)
    m = len(ranks)
    blocks = data.reshape(m, 2, 3)
    for r in ranks:
        np.testing.assert_allclose(got[r], blocks.prod(0), rtol=1e-6)
    ref = _reference(op, data, ranks)
    np.testing.assert_allclose(ref[:2], blocks.sum(0), rtol=1e-6)


def _rank_send_recv():
    import torch
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import get_rank, get_world_size

    r, n = get_rank(), get_world_size()
    out = torch.zeros(3)
    if r % 2 == 0:
        C.send(torch.full((3,), float(r)), dst=r + 1)
    else:
        C.recv(out, src=r - 1)
    return out.numpy()


@pytest.mark.parametrize("n", [2, 4])
def test_send_recv_move_a_tensor_the_reference_cannot(worlds, n):
    got = worlds(n).run(_rank_send_recv)
    for r in range(1, n, 2):
        np.testing.assert_array_equal(got[r], np.full(3, r - 1.0))
    with pytest.raises(NotImplementedError):
        jcoll.send(paddle.to_tensor(np.zeros(3, np.float32)), dst=1)


AXIS_OPS = ["psum", "pmax", "all_gather_axis", "reduce_scatter_axis",
            "all_to_all_axis", "ppermute", "axis_index"]


def _rank_axis(op, data, n):
    import torch
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import fleet

    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 1, "mp_degree": n}
    fleet.init(is_collective=True, strategy=s)
    i = C.axis_index("mp")
    k = data.shape[0] // n
    x = torch.from_numpy(data[i * k:(i + 1) * k].copy())
    if op == "axis_index":
        return np.asarray([i])
    if op == "ppermute":
        return C.ppermute(x, "mp", [(j, (j + 1) % n) for j in range(n)]) \
            .numpy()
    if op == "all_to_all_axis":
        return C.all_to_all_axis(x, "mp", 0, 0).numpy()
    if op == "all_gather_axis":
        return C.all_gather_axis(x, "mp", tiled_dim=0).numpy()
    if op == "reduce_scatter_axis":
        return C.reduce_scatter_axis(x, "mp", scatter_dim=1).numpy()
    return getattr(C, op)(x, "mp").numpy()


def _reference_axis(op, data, n):
    from jax.sharding import Mesh, PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()[:n]), ("mp",))
    fns = {
        "psum": lambda v: jcoll.psum(v, "mp"),
        "pmax": lambda v: jcoll.pmax(v, "mp"),
        "all_gather_axis": lambda v: jcoll.all_gather_axis(v, "mp"),
        "reduce_scatter_axis": lambda v: jcoll.reduce_scatter_axis(
            v, "mp", scatter_dim=1),
        "all_to_all_axis": lambda v: jcoll.all_to_all_axis(v, "mp", 0, 0),
        "ppermute": lambda v: jcoll.ppermute(
            v, "mp", [(j, (j + 1) % n) for j in range(n)]),
        "axis_index": lambda v: jcoll.axis_index("mp").reshape(1),
    }
    out = jax.shard_map(fns[op], mesh=mesh, in_specs=P("mp"),
                        out_specs=P("mp"), check_vma=False)(
        jax.numpy.asarray(data))
    return np.asarray(out)


@pytest.mark.parametrize("op", AXIS_OPS)
@pytest.mark.parametrize("n", [2, 4])
def test_axis_name_forms_match_the_reference_in_shard_map(worlds, n, op):
    data = np.random.default_rng(1).standard_normal((n * n, 4)).astype(
        np.float32)
    got = worlds(n).run(_rank_axis, op, data, n)
    want = _reference_axis(op, data, n)
    k = want.shape[0] // n
    for r in range(n):
        np.testing.assert_allclose(got[r], want[r * k:(r + 1) * k], **TOL)


# ------------------------------------------------------------- metrics ----
METRICS = ["sum", "max", "min", "mean", "acc", "auc"]


def _rank_metric(name, rows):
    from paddle_tpu_torch.distributed import get_rank
    from paddle_tpu_torch.distributed.fleet import metrics

    r = get_rank()
    if name == "acc":
        return metrics.acc(rows[0][r], rows[1][r])
    if name == "auc":
        return metrics.auc(rows[0][r], rows[1][r])
    return getattr(metrics, name)(rows[r])


@pytest.mark.parametrize("name", METRICS)
@pytest.mark.parametrize("n", [2, 4])
def test_fleet_metrics_reduce_over_ranks_as_the_reference(worlds, n, name):
    rng = np.random.default_rng(2)
    g = jcoll.new_group(list(range(n)))
    if name == "acc":
        rows = (rng.integers(0, 10, (n, 1)).astype(np.float32),
                np.full((n, 1), 10, np.float32))
        want = jmetrics.acc(rows[0], rows[1], group=g)
    elif name == "auc":
        rows = (rng.integers(0, 20, (n, 8)).astype(np.float32),
                rng.integers(0, 20, (n, 8)).astype(np.float32))
        want = jmetrics.auc(rows[0], rows[1], group=g)
    else:
        rows = rng.standard_normal((n, 3)).astype(np.float32)
        want = getattr(jmetrics, name)(rows, group=g)
    got = worlds(n).run(_rank_metric, name, rows)
    for r in range(n):
        np.testing.assert_allclose(got[r], want, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ topology ----
@pytest.mark.parametrize("dims", [(2, 1, 1, 2), (1, 2, 2, 2), (4, 1, 2, 1),
                                  (2, 3, 1, 2)])
def test_communicate_topology_coordinates_match_the_reference(dims):
    names = ["data", "pipe", "sharding", "model"]
    a = ttopo.CommunicateTopology(names, dims)
    b = jtopo.CommunicateTopology(names, dims)
    assert a.world_size() == b.world_size()
    for r in range(a.world_size()):
        assert a.get_coord(r) == b.get_coord(r)
        kw = dict(zip(names, a.get_coord(r)))
        assert a.get_rank(**kw) == b.get_rank(**kw) == r
        assert a.get_rank_from_stage(r, pipe=0) == \
            b.get_rank_from_stage(r, pipe=0)
    for ax in names:
        assert a.get_comm_list(ax) == b.get_comm_list(ax)
        assert a.get_axis_list(ax, 0) == b.get_axis_list(ax, 0)


def _rank_hcg(dp, mp, sharding):
    from paddle_tpu_torch.distributed import fleet

    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": mp,
                        "sharding_degree": sharding}
    fleet.init(is_collective=True, strategy=s)
    h = fleet.get_hybrid_communicate_group()
    return {"coord": (h.get_data_parallel_rank(), h.get_stage_id(),
                      h.get_sharding_parallel_rank(),
                      h.get_model_parallel_rank()),
            "groups": {a: h._groups[a].ranks
                       for a in ("dp", "pp", "sharding", "mp")},
            "mode": h.get_parallel_mode(),
            "worker": (fleet.worker_index(), fleet.worker_num())}


@pytest.mark.parametrize("dp,mp,sharding", [(2, 2, 1), (1, 4, 1),
                                            (4, 1, 1), (1, 2, 2),
                                            (2, 1, 1), (1, 2, 1)])
def test_hybrid_group_coordinates_and_groups_match_the_reference(
        worlds, dp, mp, sharding):
    n = dp * mp * sharding
    names = ["data", "pipe", "sharding", "model"]
    topo = jtopo.CommunicateTopology(names, [dp, 1, sharding, mp])
    ref_mode = jtopo.HybridCommunicateGroup(topo).get_parallel_mode()
    got = worlds(n).run(_rank_hcg, dp, mp, sharding)
    for r in range(n):
        assert got[r]["coord"] == topo.get_coord(r)
        for ax, name in zip(("dp", "pp", "sharding", "mp"), names):
            want = [g for g in topo.get_comm_list(name) if r in g]
            assert got[r]["groups"][ax] == want[0]
        assert got[r]["mode"] == ref_mode
        assert got[r]["worker"] == (r, n)


def _rank_pp_ep():
    from paddle_tpu_torch.distributed import fleet

    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"pp_degree": 2, "ep_degree": 2}
    fleet.init(is_collective=True, strategy=s)
    h = fleet.get_hybrid_communicate_group()
    return {"coord": (h.get_stage_id(), h.get_expert_parallel_rank()),
            "pp": h.get_pipe_parallel_group().ranks,
            "ep": h.get_expert_parallel_group().ranks,
            "batch": h.get_batch_group().ranks,
            "mode": h.get_parallel_mode()}


def test_pipeline_and_expert_degrees_build_their_groups(worlds):
    # pp_degree and ep_degree above 1 were refused; now fleet.init builds
    # the pipe and expert groups as the reference's 5-axis topology lays
    # them out (the expert axis between sharding and model)
    names = ["data", "pipe", "sharding", "expert", "model"]
    topo = jtopo.CommunicateTopology(names, [1, 2, 1, 2, 1])
    got = worlds(4).run(_rank_pp_ep)
    for r in range(4):
        c = topo.get_coord(r)
        assert got[r]["coord"] == (c[1], c[3])
        for ax, name in (("pp", "pipe"), ("ep", "expert")):
            assert got[r][ax] == [g for g in topo.get_comm_list(name)
                                  if r in g][0]
        assert got[r]["batch"] == got[r]["ep"]  # dp 1: the batch over ep
        assert got[r]["mode"] == "hybrid_parallel"


# --------------------------------------------------------------- store ----
def _store_ops(store):
    store.set("a", b"1")
    out = [store.get("a"), store.add("n", 2), store.add("n", 3),
           store.check("a"), store.check("nope")]
    store.wait(["a", "n"], timeout=1.0)
    out += [store.num_keys(), store.delete_key("a"), store.delete_key("a"),
            store.check("a"), store.num_keys()]
    return out


@pytest.mark.parametrize("server,client", [("port", "port"),
                                           ("port", "ref"),
                                           ("ref", "port")])
def test_tcpstore_ops_match_the_reference_across_bindings(server, client):
    # one wire protocol: either binding's client talks to either's server
    make = {"port": tstore.TCPStore, "ref": JStore}
    master = make[server](is_master=True, timeout=5.0)
    peer = make[client](port=master.port, timeout=5.0)
    ref_master = JStore(is_master=True, timeout=5.0)
    try:
        assert _store_ops(peer) == _store_ops(ref_master)
        # add() keeps its counter as a little-endian int64
        assert master.get("n") == (5).to_bytes(8, "little")
        with pytest.raises(TimeoutError):
            make[client](port=master.port, timeout=0.5).get("missing")
    finally:
        for s in (peer, master):
            if hasattr(s, "close"):
                s.close()


def test_tcpstore_builds_into_build_keyed_by_its_source():
    so = tstore.library()
    assert so.parent.name == "build" and so.name.startswith("tcpstore-")


@pytest.mark.parametrize("spec", [
    "store_flaky:fails=2", "store_flaky:fails=2,op=set",
    "store_slow:delay=0.05", "store_partition:secs=0.2"])
def test_store_fault_points_fire_and_retry_as_the_reference(spec):
    from paddle_tpu.testing import faults as jfaults

    results = []
    for faults, make, counters in (
            (tfaults, tstore.TCPStore, registry.counters),
            (jfaults, JStore, None)):
        s = make(is_master=True, timeout=5.0)
        faults.configure(spec)
        try:
            s.set("k", b"v")
            got = [s.get("k"), s.add("c", 1), s.check("k")]
        except ConnectionError as e:
            got = [type(e).__name__]
        finally:
            faults.reset()
        if counters is not None:
            assert counters("fault").get("injected." + spec.split(":")[0],
                                         0) >= 1
        results.append(got)
        if hasattr(s, "close"):
            s.close()
    assert results[0] == results[1]


# ------------------------------------------------------------- callers ----
def _rank_sampler(n_items, batch_size, shuffle, epoch):
    """The sampler's rank and indices: from the process group, then from
    the fleet's data-parallel group (dp = the world's size)."""
    from paddle_tpu_torch import io
    from paddle_tpu_torch.distributed import fleet, get_world_size

    out = []
    for dp in (None, get_world_size()):
        fleet._fleet_state["hcg"] = None
        if dp is not None:
            st = fleet.DistributedStrategy()
            st.hybrid_configs = {"dp_degree": dp, "mp_degree": 1}
            fleet.init(is_collective=True, strategy=st)
        s = io.DistributedBatchSampler(list(range(n_items)), batch_size,
                                       shuffle=shuffle)
        s.set_epoch(epoch)
        out.append((s.nranks, s.local_rank, list(s), len(s)))
    return out


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("n", [2, 4])
def test_distributed_sampler_takes_rank_from_the_process_group(
        worlds, n, shuffle):
    got = worlds(n).run(_rank_sampler, 11, 2, shuffle, 3)
    for r in range(n):
        ref = jio.DistributedBatchSampler(list(range(11)), 2,
                                          num_replicas=n, rank=r,
                                          shuffle=shuffle)
        ref.set_epoch(3)
        assert got[r] == [(n, r, list(ref), len(ref))] * 2


def _ckpt_state():
    rng = np.random.default_rng(7)
    return {"w": rng.standard_normal((5, 3)).astype(np.float32),
            "b": rng.standard_normal(7).astype(np.float32),
            "step": 12}


def _rank_save_sharded(d):
    import torch
    from paddle_tpu_torch.incubate.checkpoint import CheckpointManager

    st = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
          for k, v in _ckpt_state().items()}
    mgr = CheckpointManager(d, async_save=False, shard=True)
    mgr.save(st, step=5)
    return mgr.rank, mgr.world_size


def _rank_load_resharded(d):
    from paddle_tpu_torch.incubate.checkpoint import CheckpointManager

    state, man = CheckpointManager(d).load_latest(reshard=True)
    return {k: np.asarray(v) for k, v in state.items()}, man["world_size"]


def _as_np(v):
    return np.asarray(v.numpy()) if hasattr(v, "numpy") else v


def test_sharded_checkpoint_world_two_both_ways(worlds, tmp_path):
    want = _ckpt_state()
    # the port's ranks write, the reference merges
    d = str(tmp_path / "port")
    assert worlds(2).run(_rank_save_sharded, d) == [(0, 2), (1, 2)]
    state, man = jckpt.load_resharded(d, rank=0, world_size=1)
    assert man["sharded"] and man["world_size"] == 2
    for k, v in want.items():
        np.testing.assert_array_equal(_as_np(state[k]), v)
    # the reference writes two shards, the port's ranks merge them
    d = str(tmp_path / "ref")
    for r in (0, 1):
        jckpt.save_checkpoint(d, {k: paddle.to_tensor(v) if isinstance(
            v, np.ndarray) else v for k, v in want.items()}, step=5,
            rank=r, world_size=2, shard=True)
    for state, saved_w in worlds(2).run(_rank_load_resharded, d):
        assert saved_w == 2
        for k, v in want.items():
            np.testing.assert_array_equal(np.asarray(state[k]), v)


# hapi.Model.fit at dp 2 against the reference's SPMD fit
VOCAB = 64
FIT_CFG = dict(vocab_size=VOCAB, n_layer=2, n_head=2, d_model=32,
               seq_len=16, dropout=0.0)
FIT_TOKS = np.random.default_rng(0).integers(0, VOCAB, (8, 17))


def _ref_init():
    state = paddle.get_rng_state()
    try:
        paddle.seed(123)
        m = jgpt.GPTForPretraining(jgpt.GPTModel(
            jgpt.GPTConfig.preset("gpt2-tiny", **FIT_CFG)))
    finally:
        paddle.set_rng_state(state)
    return m, {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}


def _rank_fit(init, toks, lr):
    import torch
    from paddle_tpu_torch import callbacks, convert, hapi, io
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.optimizer import SGD

    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 2, "mp_degree": 1}
    fleet.init(is_collective=True, strategy=s)
    net = gpt.GPTForPretraining(gpt.GPTModel(
        gpt.GPTConfig.preset("gpt2-tiny", **FIT_CFG), device="cpu"))
    convert.load_paddle_tpu_state(net, init)
    model = hapi.Model(net)
    model.prepare(SGD(learning_rate=lr, parameters=net.parameters()),
                  gpt.GPTPretrainingCriterion())

    class Rec(callbacks.Callback):
        def __init__(self):
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])

    rec = Rec()
    model.fit(io.TensorDataset([toks[:, :-1], toks[:, 1:]]), batch_size=4,
              epochs=1, shuffle=False, verbose=0, callbacks=[rec])
    final = {k: v.detach().numpy()
             for k, v in convert.state_to_paddle_tpu(net).items()}
    return rec.losses, final, float(torch.is_grad_enabled())


def test_fit_at_dp_2_matches_the_reference_spmd_fit(worlds):
    lr = 0.1
    jm, init = _ref_init()
    s = jfleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 2, "mp_degree": 1, "pp_degree": 1,
                        "sharding_degree": 1, "use_spmd": True}
    jfleet.init(is_collective=True, strategy=s)
    try:
        model = jhapi.Model(jm)
        model.prepare(paddle.optimizer.SGD(learning_rate=lr,
                                           parameters=jm.parameters()),
                      jgpt.GPTPretrainingCriterion())
        losses = []

        class Rec(paddle.callbacks.Callback):
            def on_train_batch_end(self, step, logs=None):
                losses.append(float(np.asarray(logs["loss"]).reshape(-1)[0]))

        model.fit(jio.TensorDataset([FIT_TOKS[:, :-1], FIT_TOKS[:, 1:]]),
                  batch_size=4, epochs=1, shuffle=False, verbose=0,
                  callbacks=[Rec()])
        final = {k: np.asarray(v.numpy())
                 for k, v in jm.state_dict().items()}
    finally:
        jspmd.disable()
    got = worlds(2).run(_rank_fit, init, FIT_TOKS, lr)
    for r_losses, r_final, _ in got:
        np.testing.assert_allclose(r_losses, losses, atol=1e-5, rtol=1e-5)
        for k, v in final.items():
            key = k if k in r_final else k[len("gpt."):]
            np.testing.assert_allclose(r_final[key], v, atol=1e-5,
                                       rtol=1e-5, err_msg=k)
