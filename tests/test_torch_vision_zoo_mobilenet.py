"""The port's MobileNet V1 and V2 (scale 0.25), VGG-11 and Inception v3 (at
its smallest input, 75 x 75) against the JAX package's: each model's
forward at its smallest valid input, in eval mode (running statistics
drawn at random), with the reference's weights carried across by
``paddle_tpu_torch.convert`` (every state name matching). The zoo is split
over three files so that each runs in under a minute on one worker.

float32, one image; logits held to 1e-4 absolute and relative (float32 in
both frameworks, convolutions summed in another order).
"""
import pytest
import torch

jax = pytest.importorskip("jax")

from vision_parity import zoo_parity  # noqa: E402

# one intra-op thread: the suite's parallel workers share the CPU, and
# a torch thread pool in each would oversubscribe it
torch.set_num_threads(1)

CASES = {
    "mobilenet_v1": (
        lambda m: m.mobilenet_v1(scale=0.25, num_classes=10),
        (1, 3, 32, 32)),
    "mobilenet_v2": (
        lambda m: m.mobilenet_v2(scale=0.25, num_classes=10),
        (1, 3, 32, 32)),
    "vgg11": (lambda m: m.vgg11(num_classes=10), (1, 3, 32, 32)),
    "inception_v3": (lambda m: m.inception_v3(num_classes=10), (1, 3, 75, 75)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward(name):
    zoo_parity(*CASES[name])
