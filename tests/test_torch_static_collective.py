"""The port's static-graph collectives (``static.nn.c_allreduce_sum`` /
``max`` / ``min`` / ``prod``, ``c_broadcast``, ``c_concat``, ``c_split``)
recorded into a Program and run by the Executor on a 2-rank gloo world,
against the reference's on its virtual mesh: rank ``r`` feeds row block
``r`` of the reference's global array and must get row block ``r`` of its
result. Plus the refusals (a root outside the group, a split the group
size does not divide) and the identity over a group of one rank.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.distributed import collective as jcoll  # noqa: E402

from torch_pp_parity import make_worlds  # noqa: E402

torch.set_num_threads(1)

OPS = ["c_allreduce_sum", "c_allreduce_max", "c_allreduce_min",
       "c_allreduce_prod", "c_broadcast", "c_concat", "c_split"]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    get, close = make_worlds(tmp_path_factory)
    yield get
    close()


def _call(nn, name, v, group):
    if name == "c_broadcast":
        return nn.c_broadcast(v, root=1, group=group)
    return getattr(nn, name)(v, group=group)


def _ref(name, x):
    group = jcoll.new_group([0, 1])
    paddle.enable_static()
    try:
        main = paddle.static.Program()
        with paddle.static.program_guard(main, paddle.static.Program()):
            v = paddle.static.data("x", list(x.shape), "float32")
            out = _call(paddle.static.nn, name, v, group)
        return paddle.static.Executor().run(main, feed={"x": x},
                                            fetch_list=[out])[0]
    finally:
        paddle.disable_static()


def _rank_ops(xs):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import static
    from paddle_tpu_torch.distributed import collective, get_rank

    r = get_rank()
    group = collective.new_group([0, 1])
    outs = {}
    pt.enable_static()
    try:
        for name, x in xs.items():
            mine = x[r:r + 1]
            prog = static.Program()
            with static.program_guard(prog):
                v = static.data("x", list(mine.shape), "float32")
                out = _call(static.nn, name, v, group)
            outs[name] = static.Executor("cpu").run(
                prog, feed={"x": mine}, fetch_list=[out])[0]
    finally:
        pt.disable_static()
    return outs


def _rank_refusals():
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import static
    from paddle_tpu_torch.distributed import collective

    group = collective.new_group([0, 1])
    out = []
    for call in (lambda v: static.nn.c_broadcast(v, root=5, group=group),
                 lambda v: static.nn.c_split(v, group=group)):
        pt.enable_static()
        try:
            with static.program_guard(static.Program()):
                call(static.data("x", [1, 3], "float32"))
            out.append(None)
        except (ValueError, RuntimeError) as e:
            out.append(str(e))
        finally:
            pt.disable_static()
    one = collective.Group([collective.get_group(0).rank], 99)
    x = torch.arange(6.0).reshape(1, 6)
    out.append(all(torch.equal(getattr(static.nn, n)(x, group=one), x)
                   for n in ("c_allreduce_sum", "c_concat", "c_split")))
    return out


@pytest.mark.parametrize("name", OPS)
def test_static_collective_matches_the_reference(worlds, name):
    rng = np.random.default_rng(OPS.index(name))
    x = rng.uniform(0.5, 1.5, size=(2, 3, 4)).astype(np.float32)
    got = worlds(2).run(_rank_ops, {name: x})
    want = _ref(name, x)
    for r in range(2):
        np.testing.assert_allclose(got[r][name], want[r:r + 1], rtol=1e-6)


def test_static_collective_refusals(worlds):
    bad_root, bad_split, identity = worlds(2).run(_rank_refusals)[0]
    assert "c_broadcast root 5" in bad_root
    assert "not divisible" in bad_split
    assert identity
