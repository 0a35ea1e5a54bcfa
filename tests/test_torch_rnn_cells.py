"""The port's recurrent cells (``paddle_tpu_torch.nn``: SimpleRNNCell,
LSTMCell, GRUCell) and ``RNN``, which runs a cell over time, against the
JAX package's, with the reference's weights carried by ``convert``:
outputs, states and the gradients of the inputs, the states and every
weight, forward and reversed, batch- and time-major.

Inputs: small float32 arrays from a seeded numpy generator; everything is
held to 1e-5 absolute and relative (float32 in both frameworks, summed in
another order). The reference faults of the layers' ``sequence_length``
and ``dropout`` (ROADMAP queue 3) run both packages.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu_torch import nn as tnn  # noqa: E402
from paddle_tpu_torch.nn import functional as tF  # noqa: E402
from rnn_parity import _arr, _close, pair, parity  # noqa: E402
from vision_parity import _j, _np, _t  # noqa: E402

# one intra-op thread: the suite's parallel workers share the CPU, and
# a torch thread pool in each would oversubscribe it
torch.set_num_threads(1)

I, H, B, T = 3, 4, 2, 5


def _layer(pkg, mode, layers, direction):
    cls = {"lstm": "LSTM", "gru": "GRU"}[mode]
    return getattr(pkg, cls)(I, H, num_layers=layers, direction=direction)


CELLS = {"rnn_tanh": ("SimpleRNNCell", dict(activation="tanh")),
         "rnn_relu": ("SimpleRNNCell", dict(activation="relu")),
         "lstm": ("LSTMCell", {}), "gru": ("GRUCell", {})}


@pytest.mark.parametrize("states", [False, True])
@pytest.mark.parametrize("mode", sorted(CELLS))
def test_cell(mode, states):
    cls, kw = CELLS[mode]
    jm, tm = pair(lambda: getattr(paddle.nn, cls)(I, H, **kw),
                  lambda: getattr(tnn, cls)(I, H, **kw))
    arrays = [_arr((B, I), 1)]
    if states:
        arrays += [_arr((B, H), 2)] * (2 if mode == "lstm" else 1)

    def call(m, x, *s):
        if not s:
            return m(x)
        return m(x, tuple(s) if mode == "lstm" else s[0])

    parity(jm, tm, call, arrays)


@pytest.mark.parametrize("is_reverse,time_major", [(False, True),
                                                   (True, False)])
@pytest.mark.parametrize("cell", ["LSTMCell", "GRUCell"])
def test_rnn_runs_a_cell_over_time(cell, is_reverse, time_major):
    jm, tm = pair(lambda: paddle.nn.RNN(getattr(paddle.nn, cell)(I, H),
                                        is_reverse, time_major),
                  lambda: tnn.RNN(getattr(tnn, cell)(I, H), is_reverse,
                                  time_major))
    x = _arr((T, B, I) if time_major else (B, T, I), 1)
    parity(jm, tm, lambda m, x: m(x), [x])


def test_get_initial_states():
    cell = tnn.LSTMCell(I, H)
    s = cell.get_initial_states(torch.zeros(3, 7, I), batch_dim_idx=1,
                                init_value=0.5, dtype="float64")
    assert s.shape == (7, H) and s.dtype == torch.float64
    assert float(s.min()) == float(s.max()) == 0.5


# ---------------------------------------------------- reference faults --
def _ref(jm, x, **kw):
    """The reference layer's forward on ``x``, as one compiled program."""
    with paddle.no_grad(), paddle.incubate.lazy_eval():
        out = jm(_j(x), **kw)
        return jax.tree_util.tree_map(lambda t: _np(t), out)



@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_reference_fault_sequence_length(mode):
    """Paddle's ``sequence_length``: outputs past each length are zero,
    the final states are those of each sequence's last valid step, and the
    backward direction runs over each sequence's own steps in reverse; the
    port's run of a padded batch equals the reference's run of each
    sequence alone. The reference ignores ``sequence_length``."""
    jm, tm = pair(lambda: _layer(paddle.nn, mode, 2, "bidirect"),
                  lambda: _layer(tnn, mode, 2, "bidirect"))
    lens = np.array([5, 3], np.int64)
    x = _arr((B, T, I), 1)
    out, state = tm(_t(x), sequence_length=_t(lens))
    h = state[0] if mode == "lstm" else state
    for b, n in enumerate(lens):
        j_out, j_state = _ref(jm, x[b:b + 1, :n])
        j_h = j_state[0] if mode == "lstm" else j_state
        _close(out[b:b + 1, :n], j_out, f"sequence {b} outputs")
        _close(h[:, b:b + 1], j_h, f"sequence {b} final states")
        assert not _np(out[b, n:]).any()
    j_out, _ = _ref(jm, x, sequence_length=_j(lens))
    _close(j_out, _ref(jm, x)[0])
    assert np.abs(_np(j_out)[1, 3:]).max() > 1e-3


def test_reference_fault_dropout():
    """Paddle's ``dropout`` drops each layer's output but the last's in
    training; the reference stores it and never applies it."""
    jm, tm = pair(lambda: paddle.nn.LSTM(I, H, num_layers=2, dropout=0.5),
                  lambda: tnn.LSTM(I, H, num_layers=2, dropout=0.5))
    x = _arr((B, T, I), 1)
    keys = tnn.DropoutKeys()
    keys.attach(tm)
    keys.key = torch.tensor([7, 11])
    tm.train()
    out, _ = tm(_t(x))
    # by hand: layer 0, the dropout keyed as the layer's, layer 1
    one = [tnn.LSTM(I, H), tnn.LSTM(H, H)]
    for k, m in enumerate(one):
        m.load_state_dict({n.replace(f"_l{k}", "_l0"): v for n, v in
                           tm.state_dict().items() if f"_l{k}" in n})
    mid, _ = one[0](_t(x))
    # the layers run time-major inside, and so does the mask
    dropped = tF.dropout(mid.transpose(0, 1), 0.5, key=keys.key,
                         site=tm.dropouts[0].site).transpose(0, 1)
    want, _ = one[1](dropped)
    _close(out, want)
    tm.eval()
    _close(tm(_t(x))[0], _ref(jm, x)[0])
    assert np.abs(_np(out) - _np(tm(_t(x))[0])).max() > 1e-3
    jm.train()
    _close(_ref(jm, x)[0], tm(_t(x))[0])
