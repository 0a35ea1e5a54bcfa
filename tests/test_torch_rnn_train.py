"""A tiny LSTM language model's training step through the port's
``jit.TrainStep`` (its CPU route) against the reference's ``jit.TrainStep``
on the same weights and batches, and ``convert`` of the recurrent layers'
states both ways.

The model: Embedding, a 2-layer LSTM without dropout, Linear, float32;
SGD with a global-norm clip, whose update does not read the step count
(the reference's ``TrainStep`` advances the count twice per call, ROADMAP
queue 3). Losses and every parameter after each step are held to 1e-5
absolute and relative.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu_torch import convert  # noqa: E402
from paddle_tpu_torch import jit as tjit  # noqa: E402
from paddle_tpu_torch import nn as tnn  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch.nn import functional as tF  # noqa: E402
from rnn_parity import _close  # noqa: E402
from vision_parity import _seeded, _state  # noqa: E402

# one intra-op thread: the suite's parallel workers share the CPU, and
# a torch thread pool in each would oversubscribe it
torch.set_num_threads(1)

V, E, H, B, T = 50, 8, 12, 3, 7


def _lm(pkg, base):
    class LM(base):
        def __init__(self):
            super().__init__()
            self.embed = pkg.Embedding(V, E)
            self.rnn = pkg.LSTM(E, H, num_layers=2)
            self.head = pkg.Linear(H, V)

        def forward(self, tokens):
            out, _ = self.rnn(self.embed(tokens))
            return self.head(out)

    return LM()


def _batches(n):
    rng = np.random.default_rng(3)
    toks = rng.integers(0, V, (n, B, T + 1))
    return [(t[:, :-1], t[:, 1:]) for t in toks]


def test_lstm_lm_train_step_matches_the_reference():
    jm = _seeded(lambda: _lm(paddle.nn, paddle.nn.Layer))
    tm = _lm(tnn, torch.nn.Module)
    convert.load_paddle_tpu_state(tm, _state(jm))
    jopt = paddle.optimizer.SGD(
        learning_rate=1.0, parameters=jm.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(0.5))
    topt_ = topt.SGD(learning_rate=1.0, parameters=tm.parameters(),
                     grad_clip=tnn.ClipGradByGlobalNorm(0.5))

    def jstep(x, y):
        loss = paddle.nn.functional.cross_entropy(
            jm(x).reshape([-1, V]), y.reshape([-1]))
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        return loss

    def tstep(x, y):
        loss = tF.cross_entropy(tm(x).reshape(-1, V), y.reshape(-1))
        loss.backward()
        topt_.step()
        topt_.clear_grad()
        return loss

    jtrain = paddle.jit.TrainStep(jstep, jm, jopt)
    ttrain = tjit.TrainStep(tstep, tm, topt_)
    for x, y in _batches(2):
        jl = jtrain(paddle.to_tensor(x), paddle.to_tensor(y))
        tl = ttrain(torch.from_numpy(x), torch.from_numpy(y))
        _close(tl, jl, "loss")
        got = convert.state_to_paddle_tpu(tm)
        for name, want in _state(jm).items():
            _close(got[name], want, name)


@pytest.mark.parametrize("make", [
    lambda nn: nn.LSTM(3, 4, num_layers=2, direction="bidirect"),
    lambda nn: nn.GRU(3, 4, time_major=True),
    lambda nn: nn.SimpleRNN(3, 4, num_layers=2, activation="relu"),
    lambda nn: nn.LSTMCell(3, 4),
    lambda nn: nn.GRUCell(3, 4),
    lambda nn: nn.SimpleRNNCell(3, 4)],
    ids=["lstm", "gru", "simple_rnn", "lstm_cell", "gru_cell",
         "simple_rnn_cell"])
def test_convert_both_ways(make):
    """The recurrent weights are ``[gates * H, in]`` in both packages:
    carried as they are, not transposed like a Linear's."""
    jm = _seeded(lambda: make(paddle.nn))
    tm = make(tnn)
    ref = _state(jm)
    convert.load_paddle_tpu_state(tm, ref)
    for name, p in tm.state_dict().items():
        np.testing.assert_array_equal(p.numpy(), ref[name])
    back = convert.state_to_paddle_tpu(tm)
    assert set(back) == set(ref)
    for name, v in back.items():
        np.testing.assert_array_equal(v.numpy(), ref[name])
    jm2 = make(paddle.nn)
    jm2.set_state_dict({k: paddle.to_tensor(v.numpy())
                        for k, v in back.items()})
    for name, v in _state(jm2).items():
        np.testing.assert_array_equal(v, ref[name])
