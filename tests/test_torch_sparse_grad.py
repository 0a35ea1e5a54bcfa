"""Row-wise updates from a sparse embedding gradient against the JAX
package's ``SelectedRows`` route.

The port's counterpart of a ``SelectedRows`` gradient is the sparse COO
gradient of ``torch.nn.Embedding(sparse=True)``: SGD adds its rows
(duplicates summed, as the reference's row update sums them) and
``Adam(lazy_mode=True)`` updates only the looked-up rows' moments and
weights from the coalesced gradient (the reference's ``merged()``).
Anything that needs the whole gradient (a regularizer, a clip, an
optimizer without a row-wise rule, AdamW's decoupled decay) makes it
dense first, as the reference does. Same numpy weights and ids in both
packages, 3 steps; tolerance 2e-6 (float32, the same operations).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.core.selected_rows import SelectedRows  # noqa: E402
from paddle_tpu_torch import nn as tnn  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch import regularizer as treg  # noqa: E402

TOL = dict(atol=2e-6, rtol=2e-6)
V, D = 10, 4
# rows 7, 8 and 9 are never looked up; 1 and 3 are looked up twice or more
IDS = np.array([[1, 3, 3, 0, 5], [6, 1, 2, 3, 4], [0, 2, 1, 1, 6]])


def _data():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((V, D)).astype(np.float32),
            [rng.standard_normal(IDS.shape + (D,)).astype(np.float32)
             for _ in range(3)])


def _optimizers(kind):
    """(reference optimizer factory, port optimizer factory)."""
    if kind == "sgd":
        return (lambda ps: paddle.optimizer.SGD(0.1, parameters=ps),
                lambda ps: topt.SGD(0.1, parameters=ps))
    if kind == "lazy_adam":
        return (lambda ps: paddle.optimizer.Adam(0.05, parameters=ps,
                                                 lazy_mode=True),
                lambda ps: topt.Adam(0.05, parameters=ps, lazy_mode=True))
    if kind == "sgd_l2":
        return (lambda ps: paddle.optimizer.SGD(
                    0.1, parameters=ps,
                    weight_decay=paddle.regularizer.L2Decay(0.1)),
                lambda ps: topt.SGD(0.1, parameters=ps,
                                    weight_decay=treg.L2Decay(0.1)))
    if kind == "lazy_adam_clip":
        return (lambda ps: paddle.optimizer.Adam(
                    0.05, parameters=ps, lazy_mode=True,
                    grad_clip=paddle.nn.ClipGradByGlobalNorm(0.5)),
                lambda ps: topt.Adam(0.05, parameters=ps, lazy_mode=True,
                                     grad_clip=tnn.ClipGradByGlobalNorm(0.5)))
    if kind == "adam":
        return (lambda ps: paddle.optimizer.Adam(0.05, parameters=ps),
                lambda ps: topt.Adam(0.05, parameters=ps))
    if kind == "adamw_lazy":
        return (lambda ps: paddle.optimizer.AdamW(0.05, parameters=ps,
                                                  lazy_mode=True),
                lambda ps: topt.AdamW(0.05, parameters=ps, lazy_mode=True))
    raise ValueError(kind)


def _run(kind, steps=3, dense_only=False):
    w, targets = _data()
    jmake, tmake = _optimizers(kind)
    jemb = paddle.nn.Embedding(V, D, sparse=True)
    jemb.weight.set_value(w)
    temb = torch.nn.Embedding(V, D, sparse=True)
    with torch.no_grad():
        temb.weight.copy_(torch.from_numpy(w))
    jopt, topt_ = jmake(jemb.parameters()), tmake(temb.parameters())
    if dense_only:
        def row_update(*args):
            raise AssertionError(f"{kind}: a row-wise update ran")
        topt_._apply_one_sparse = row_update
    ids_j, ids_t = paddle.to_tensor(IDS), torch.from_numpy(IDS)
    for s in range(steps):
        (jemb(ids_j) * paddle.to_tensor(targets[s])).sum().backward()
        (temb(ids_t) * torch.from_numpy(targets[s])).sum().backward()
        assert isinstance(jemb.weight.grad, SelectedRows)
        assert temb.weight.grad.is_sparse
        jopt.step()
        jopt.clear_grad()
        topt_.step()
        topt_.clear_grad()
    return w, jemb, temb, jopt, topt_


def _close(jemb, temb, jopt, topt_):
    np.testing.assert_allclose(temb.weight.detach().numpy(),
                               np.asarray(jemb.weight.numpy()), **TOL)
    jsd, tsd = jopt.state_dict(), topt_.state_dict()
    assert sorted(jsd) == sorted(tsd)
    for key, v in jsd.items():
        if key != "_opt_step":
            np.testing.assert_allclose(tsd[key].numpy(),
                                       np.asarray(v.numpy()), **TOL,
                                       err_msg=key)


@pytest.mark.parametrize("kind", ["sgd", "lazy_adam"])
def test_row_wise_updates_match_and_leave_other_rows(kind):
    w, jemb, temb, jopt, topt_ = _run(kind)
    _close(jemb, temb, jopt, topt_)
    untouched = sorted(set(range(V)) - set(IDS.ravel()))
    got = temb.weight.detach().numpy()
    np.testing.assert_array_equal(got[untouched], w[untouched])
    if kind == "lazy_adam":
        for acc in ("moment1", "moment2"):
            assert not topt_.state_dict()[f"{acc}/p0"][untouched].any()


@pytest.mark.parametrize("kind", ["sgd_l2", "lazy_adam_clip", "adam",
                                  "adamw_lazy"])
def test_whole_gradient_updates_densify_first(kind):
    # a regularizer, a clip, a non-lazy Adam and AdamW's decay each need
    # the whole gradient: every row moves (or decays its moments)
    w, jemb, temb, jopt, topt_ = _run(kind, dense_only=True)
    _close(jemb, temb, jopt, topt_)
    untouched = sorted(set(range(V)) - set(IDS.ravel()))
    got = temb.weight.detach().numpy()
    if kind in ("sgd_l2", "adamw_lazy"):
        assert not np.array_equal(got[untouched], w[untouched])


def test_sparse_gradient_densifies_to_the_dense_sum():
    # the embedding's sparse gradient, uncoalesced (SGD's rows) or
    # coalesced (lazy Adam's), makes the dense sum over repeated lookups
    temb = torch.nn.Embedding(V, D, sparse=True)
    (temb(torch.from_numpy(IDS)).sum()).backward()
    g = temb.weight.grad
    dense = torch.zeros(V, D).index_add_(0, torch.from_numpy(IDS.ravel()),
                                         torch.ones(IDS.size, D))
    torch.testing.assert_close(g.to_dense(), dense)
    torch.testing.assert_close(g.coalesce().to_dense(), dense)
