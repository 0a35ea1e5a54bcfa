"""Named random streams for tensor parallelism (counterpart of
paddle_tpu/distributed/meta_parallel/random_ctrl.py).

``RNGStatesTracker`` keeps named ``torch.Generator`` states;
``with tracker.rng_state(name):`` makes torch's default generator (the
CPU's and the current CUDA device's) draw from the named stream, then
stores where the stream got to and puts the default generator back.
:func:`model_parallel_random_seed` seeds the default generator alike on
every rank (dropout outside a column-parallel region draws the same masks
everywhere) and the ``model_parallel_rng`` stream per mp rank (dropout
inside one, on this rank's heads or columns, draws its own). The port's
GPT needs neither: its hashed masks give the same split by hashing each
element's index in the whole array (``models/gpt.py``).
"""
from __future__ import annotations

import contextlib
import random

import torch

__all__ = ["RNGStatesTracker", "get_rng_state_tracker",
           "model_parallel_random_seed", "MODEL_PARALLEL_RNG"]

MODEL_PARALLEL_RNG = "model_parallel_rng"


def _default_states():
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    return (torch.get_rng_state(),
            torch.cuda.get_rng_state() if cuda else None)


def _set_default_states(states):
    cpu, cuda = states
    torch.set_rng_state(cpu)
    if cuda is not None:
        torch.cuda.set_rng_state(cuda)


class RNGStatesTracker:
    def __init__(self):
        self.states = {}

    def reset(self):
        self.states = {}

    def add(self, name, seed):
        if name in self.states:
            raise ValueError(f"state {name} already exists")
        orig = _default_states()
        torch.manual_seed(int(seed))
        self.states[name] = _default_states()
        _set_default_states(orig)

    def get_states_tracker(self):
        return dict(self.states)

    def set_states_tracker(self, states):
        self.states = dict(states)

    @contextlib.contextmanager
    def rng_state(self, name=MODEL_PARALLEL_RNG):
        if name not in self.states:
            self.add(name, hash(name) % (2 ** 31))
        orig = _default_states()
        _set_default_states(self.states[name])
        try:
            yield
        finally:
            self.states[name] = _default_states()
            _set_default_states(orig)


_tracker = RNGStatesTracker()


def get_rng_state_tracker():
    return _tracker


def model_parallel_random_seed(seed=None):
    """Seed the shared stream with ``seed`` and this rank's
    ``model_parallel_rng`` stream with ``seed + 1007 + 1000 * mp_rank``
    (a random seed when None)."""
    from .. import fleet

    seed = seed if seed is not None else random.randint(0, 2 ** 31)
    hcg = fleet.get_hybrid_communicate_group()
    mp_rank = hcg.get_model_parallel_rank() if hcg is not None else 0
    _tracker.reset()
    torch.manual_seed(seed)
    _tracker.add(MODEL_PARALLEL_RNG, seed + 1007 + 1000 * mp_rank)
