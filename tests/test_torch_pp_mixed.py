"""``PipelineSpmdStep`` of the port at dp 2 x pp 2 and mp 2 x pp 2 (4
gloo ranks) against the reference's on its virtual mesh: losses of 4
AdamW steps and the merged parameters within 1e-5. The rank side is
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


@pytest.mark.parametrize("dp,mp", [(2, 1), (1, 2)])
def test_pp2_with_dp_or_mp_matches_the_reference(worlds, dp, mp):
    init, losses, final, _ = _ref_pp(dp, mp, 2)
    toks, labels = batch()
    _check(worlds(4).run(_rank_pp, init, dp, mp, 2, toks, labels), losses,
           final)
