"""``PipelineSpmdStep`` of the port at sharding 2 x pp 2 behind
``group_sharded_parallel`` at ``os_g`` and ``p_g_os`` (4 gloo ranks)
against the reference's on its virtual mesh: losses of 4 AdamW steps and
the merged parameters within 1e-5, and each rank's share of its stage's
optimizer state and parameters. The rank side is
``tests/test_torch_pp.py``'s."""
import pytest
import torch

jax = pytest.importorskip("jax")

from test_torch_pp import _check, _rank_pp, _ref_pp  # noqa: E402
from torch_pp_parity import batch, make_worlds  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    get, close = make_worlds(tmp_path_factory)
    yield get
    close()


@pytest.mark.parametrize("level", ["os_g", "p_g_os"])
def test_pp2_with_zero_matches_the_reference(worlds, level):
    # the step keeps group_sharded_parallel's optimizer: gradients
    # reduce-scattered, each rank updating its half of its stage's slots
    init, losses, final, _ = _ref_pp(1, 1, 2, 2, level)
    toks, labels = batch()
    got = worlds(4).run(_rank_pp, init, 1, 1, 2, toks, labels, None, 2, 2,
                        level)
    _check(got, losses, final)
    for r in got:
        held = r["held"]
        assert held["level"] == level
        # two float32 moments of half of every parameter of the stage
        assert held["optimizer"] == held["stage_whole"], held
        # p_g_os holds half of each of the stage's parameters of ndim >= 2
        assert held["held_2d"] * (2 if level == "p_g_os" else 1) == \
            held["whole_2d"], held
