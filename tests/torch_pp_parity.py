"""Reference-side helpers of the port's pipeline, engine, ZeRO, expert-
parallel and config-4 parity tests (``tests/test_torch_pp.py``,
``test_torch_hybrid_engine.py``, ``test_torch_sharding.py``,
``test_torch_moe_ep.py``, ``test_torch_config4.py``).

The reference is one controller over the 8 virtual CPU devices that
``tests/conftest.py`` forces; the port runs one process per rank
(``paddle_tpu_torch.testing.world.World``). Rank functions live in the
test files (they are pickled by value and import torch and the port
only); this module is imported by the test process alone.
"""
import numpy as np

import paddle_tpu as paddle
from paddle_tpu.distributed import collective as jcoll
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed import spmd as jspmd
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch.testing.world import World

V, T = 64, 16
GPT_CFG = dict(vocab_size=V, seq_len=T, dropout=0.0, n_head=2, d_model=32)
TOL = dict(atol=1e-5, rtol=1e-5)


def batch(B=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, V, (B, T)).astype(np.int64)
    return toks, np.roll(toks, -1, 1)


def make_worlds(tmp_path_factory, timeout=60):
    """``(get, close)``: ``get(n)`` is the module's world of ``n`` ranks
    (built once); ``close()`` stops them and puts back the reference's
    process-global mesh and fleet state."""
    made = {}
    mesh, groups = jcoll._global_mesh, dict(jcoll._groups)
    fleet_state = dict(jfleet._fleet_state)

    def get(n):
        if n not in made:
            made[n] = World(n, tmp_path_factory.mktemp(f"world{n}"),
                            timeout=timeout)
        return made[n]

    def close():
        for w in made.values():
            w.close()
        jspmd.disable()
        jcoll._global_mesh = mesh
        jcoll._groups.clear()
        jcoll._groups.update(groups)
        jfleet._fleet_state.clear()
        jfleet._fleet_state.update(fleet_state)

    return get, close


def ref_fleet(dp=1, mp=1, pp=1, sharding=1, ep=1, use_spmd=False, M=2):
    s = jfleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": mp, "pp_degree": pp,
                        "sharding_degree": sharding, "ep_degree": ep,
                        "use_spmd": use_spmd}
    s.pipeline_configs = {"accumulate_steps": M}
    jfleet.init(is_collective=True, strategy=s)
    return s, jfleet.get_hybrid_communicate_group()


def ref_gpt(n_layer=2, seed=123, **kw):
    """The reference's gpt2-tiny and its initial state (numpy, the
    reference's layout)."""
    paddle.seed(seed)
    model = jgpt.GPTForPretraining(jgpt.GPTModel(jgpt.GPTConfig.preset(
        "gpt2-tiny", n_layer=n_layer, **dict(GPT_CFG, **kw))))
    init = {k: np.asarray(v.numpy()) for k, v in model.state_dict().items()}
    return model, init


def state_np(model):
    return {k: np.asarray(v.numpy()) for k, v in model.state_dict().items()}


def rng_guard():
    """Context manager that restores the reference's RNG state."""
    import contextlib

    @contextlib.contextmanager
    def guard():
        state = paddle.get_rng_state()
        try:
            yield
        finally:
            jspmd.disable()
            paddle.set_rng_state(state)

    return guard()


def assert_states_close(got, want, **tol):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, err_msg=k, **(tol or TOL))

