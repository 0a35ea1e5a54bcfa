"""The port's recurrent layers (``paddle_tpu_torch.nn``: SimpleRNN, LSTM,
GRU, their cells and ``RNN``) against the JAX package's, with the
reference's weights carried by ``convert``: outputs, final states and the
gradients of the inputs, the initial states and every weight, over one and
two layers, one and two directions, batch- and time-major inputs, with and
without initial states.

Inputs: small float32 arrays from a seeded numpy generator; everything is
held to 1e-5 absolute and relative (float32 in both frameworks, summed in
another order). The cells, ``RNN`` and the reference faults are in
``test_torch_rnn_cells.py``; the training step and ``convert`` both ways
in ``test_torch_rnn_train.py``.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu_torch import nn as tnn  # noqa: E402
from rnn_parity import _arr, _close, pair, parity  # noqa: E402

# one intra-op thread: the suite's parallel workers share the CPU, and
# a torch thread pool in each would oversubscribe it
torch.set_num_threads(1)

I, H, B, T = 3, 4, 2, 5

MODES = {"rnn_tanh": ("SimpleRNN", dict(activation="tanh")),
         "rnn_relu": ("SimpleRNN", dict(activation="relu")),
         "lstm": ("LSTM", {}), "gru": ("GRU", {})}
# (layers, direction, time_major, initial states): every mode meets every
# value of each
SHAPES = [(1, "forward", False, False), (1, "bidirect", True, True),
          (2, "forward", True, False), (2, "bidirectional", False, True)]


class tnn_pkg:  # the port's package in the reference's shape: pkg.nn
    nn = tnn


def _layer(pkg, mode, layers, direction, time_major):
    cls, kw = MODES[mode]
    return getattr(pkg.nn, cls)(I, H, num_layers=layers, direction=direction,
                                time_major=time_major, **kw)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_layer(mode, shape):
    layers, direction, time_major, initial = shape
    jm, tm = pair(lambda: _layer(paddle, mode, *shape[:3]),
                  lambda: _layer(tnn_pkg, mode, *shape[:3]))
    D = 1 if direction == "forward" else 2
    x = _arr((T, B, I) if time_major else (B, T, I), 1)
    arrays = [x]
    if initial:
        arrays += [_arr((layers * D, B, H), 2, 0.5)]
        if mode == "lstm":
            arrays += [_arr((layers * D, B, H), 3, 0.5)]

    def call(m, x, *states):
        if not states:
            return m(x)
        return m(x, tuple(states) if mode == "lstm" else states[0])

    outs = parity(jm, tm, call, arrays)
    assert outs[0].shape == ((T, B, D * H) if time_major else (B, T, D * H))
    assert outs[1].shape == (layers * D, B, H)
