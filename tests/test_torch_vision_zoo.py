"""The port's LeNet, AlexNet, SqueezeNet 1.1, ShuffleNet V2 (x0.25) and
MobileNet V3 small (scale 0.5) against the JAX package's: each model's
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
    "LeNet": (lambda m: m.LeNet(), (1, 1, 28, 28)),
    "alexnet": (lambda m: m.alexnet(num_classes=10), (1, 3, 64, 64)),
    "squeezenet1_1": (
        lambda m: m.squeezenet1_1(num_classes=10),
        (1, 3, 64, 64)),
    "shufflenet_v2_x0_25": (
        lambda m: m.shufflenet_v2_x0_25(num_classes=10),
        (1, 3, 32, 32)),
    "mobilenet_v3_small": (
        lambda m: m.mobilenet_v3_small(scale=0.5, num_classes=10),
        (1, 3, 32, 32)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward(name):
    zoo_parity(*CASES[name])
