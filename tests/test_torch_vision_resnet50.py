"""The port's ResNet-50 (BASELINE config 1's model) against the JAX
package's at its full width and depth, 1000 classes; and ResNet-18 in
eval mode.

``convert.state_from_paddle_tpu`` takes the reference's whole
``state_dict()`` (parameters and every ``_mean`` / ``_variance``) with no
missing or extra name, and the port's state names are the reference's
letter for letter. One image of 3 x 32 x 32, float32: the logits in
training mode (batch statistics; at 1 x 1 spatial size a channel has one
value, whose normalised output is 0 in both) to 1e-4 absolute and
relative, and in eval mode (running statistics drawn at random, so the
activations grow through the 53 layers) to 5e-4 (float32 in both
frameworks, convolutions summed in another order). ResNet-18 in eval
mode, 3 images, running statistics drawn at random: logits to 1e-4.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.vision import models as jmodels  # noqa: E402
from paddle_tpu_torch import convert  # noqa: E402
from paddle_tpu_torch.vision import models as tmodels  # noqa: E402
from vision_parity import _seeded, _state  # noqa: E402

# one intra-op thread: the suite's parallel workers share the CPU, and
# a torch thread pool in each would oversubscribe it
torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def pair():
    jm = _seeded(lambda: jmodels.resnet50())
    state = _state(jm)
    rng = np.random.default_rng(1)
    for k in state:
        if k.endswith("_mean"):
            state[k] = rng.standard_normal(state[k].shape).astype(np.float32)
        elif k.endswith("_variance"):
            state[k] = rng.uniform(0.5, 2.0, state[k].shape).astype(
                np.float32)
    tm = tmodels.resnet50(device="cpu")
    return jm, tm, state


def test_state_names_and_convert(pair):
    jm, tm, state = pair
    assert sorted(tm.state_dict()) == sorted(state)
    assert "layer1.0.downsample.1._mean" in tm.state_dict()
    assert sum(p.numel() for p in tm.parameters()) == 25557032
    loaded = convert.state_from_paddle_tpu(state, tm)
    assert sorted(loaded) == sorted(state)
    tm.load_state_dict(loaded, strict=True)
    back = convert.state_to_paddle_tpu(tm)
    for k, v in state.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_resnet50_forward(pair, mode):
    jm, tm, state = pair
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    convert.load_paddle_tpu_state(tm, state)
    getattr(jm, mode)()
    getattr(tm, mode)()
    x = np.random.default_rng(2).standard_normal((1, 3, 32, 32)).astype(
        np.float32)
    with paddle.no_grad():
        want = np.asarray(jm(paddle.to_tensor(x)).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 1000)
    tol = TOL if mode == "train" else dict(atol=5e-4, rtol=5e-4)
    np.testing.assert_allclose(got, want, **tol)


def test_resnet18_eval_uses_running_statistics():
    jm = _seeded(lambda: jmodels.resnet18(num_classes=10), seed=3)
    tm = tmodels.resnet18(num_classes=10, device="cpu")
    state = _state(jm)
    rng = np.random.default_rng(4)
    for k in state:
        if k.endswith("_mean"):
            state[k] = rng.standard_normal(state[k].shape).astype(np.float32)
        elif k.endswith("_variance"):
            state[k] = rng.uniform(0.5, 2.0, state[k].shape).astype(
                np.float32)
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    convert.load_paddle_tpu_state(tm, state)
    jm.eval()
    tm.eval()
    x = np.random.default_rng(5).standard_normal((3, 3, 32, 32)).astype(
        np.float32)
    with paddle.no_grad():
        want = np.asarray(jm(paddle.to_tensor(x)).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
