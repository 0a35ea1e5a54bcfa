"""The port's vision transforms and datasets against the JAX package's,
and its ``SyncBatchNorm`` over two ranks.

Transforms: the same seeded uint8 / float32 images through both packages'
transforms, the random ones under the same ``random.seed``: outputs equal
(float32 arithmetic in the same order: 1e-6). Datasets: synthetic files
this test writes (idx gzip for MNIST, python-pickle tarballs for CIFAR-10
and CIFAR-100) read by both packages, items equal exactly; a missing file
raises ``FileNotFoundError``. SyncBatchNorm: two ranks of a gloo world on
the CPU, each with half of a batch, against ``BatchNorm2D`` over the whole
batch: outputs, input and parameter gradients (the ranks' summed) and
running statistics to 1e-5 absolute and relative (float32; the statistics
summed over ranks in another order).
"""
import gzip
import io
import pickle
import random
import tarfile

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu.vision.datasets as jds  # noqa: E402
import paddle_tpu.vision.transforms as jT  # noqa: E402
from paddle_tpu_torch.testing.world import World  # noqa: E402
from paddle_tpu_torch.vision import datasets as tds  # noqa: E402
from paddle_tpu_torch.vision import transforms as tT  # noqa: E402

# one intra-op thread: the suite's parallel workers share the CPU, and
# a torch thread pool in each would oversubscribe it
torch.set_num_threads(1)


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.numpy()
    return np.asarray(v.numpy() if hasattr(v, "numpy") else v)


IMG = np.random.default_rng(0).integers(0, 256, (9, 12, 3)).astype(np.uint8)

TRANSFORMS = {
    "to_tensor_chw": lambda T: T.ToTensor(),
    "to_tensor_hwc": lambda T: T.ToTensor("HWC"),
    "normalize": lambda T: T.Compose([T.ToTensor(),
                                      T.Normalize([0.5, 0.4, 0.3],
                                                  [0.2, 0.3, 0.4])]),
    "resize_pair": lambda T: T.Resize((5, 7)),
    "resize_short_side": lambda T: T.Resize(6),
    "center_crop": lambda T: T.CenterCrop(5),
    "random_crop_padded": lambda T: T.RandomCrop(8, padding=2),
    "hflip": lambda T: T.RandomHorizontalFlip(1.0),
    "vflip": lambda T: T.RandomVerticalFlip(1.0),
    "transpose": lambda T: T.Transpose(),
    "brightness": lambda T: T.BrightnessTransform(0.4),
    "pad": lambda T: T.Pad((1, 2, 3, 0), fill=7),
    "rotation": lambda T: T.RandomRotation(90),
    "functional": lambda T: T.Compose([
        lambda im: T.crop(im, 1, 2, 6, 8), T.hflip, T.vflip,
        lambda im: T.center_crop(im, 4), lambda im: T.resize(im, (8, 8)),
        T.to_tensor, lambda t: T.normalize(t, [0.5] * 3, [0.25] * 3)]),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform(name):
    outs = []
    for T in (jT, tT):
        random.seed(3)
        outs.append(_np(TRANSFORMS[name](T)(IMG)))
    np.testing.assert_allclose(outs[1], outs[0], atol=1e-6, rtol=1e-6)


def test_to_tensor_is_a_torch_tensor():
    t = tT.ToTensor()(IMG)
    assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
    assert t.shape == (3, 9, 12) and float(t.max()) <= 1.0


def test_fake_data():
    a, b = jds.FakeData(5, (3, 8, 8), seed=2), tds.FakeData(5, (3, 8, 8),
                                                            seed=2)
    assert len(b) == 5
    for i in range(5):
        np.testing.assert_array_equal(b[i][0], a[i][0])
        assert b[i][1] == a[i][1] and b[i][1].dtype == np.int64


def _idx(path, arr, magic):
    head = magic.to_bytes(4, "big") + b"".join(
        d.to_bytes(4, "big") for d in arr.shape)
    with gzip.open(path, "wb") as f:
        f.write(head + arr.astype(np.uint8).tobytes())


def test_mnist_from_local_files(tmp_path):
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, (6, 28, 28))
    labels = rng.integers(0, 10, (6,))
    ip, lp = tmp_path / "img.gz", tmp_path / "lab.gz"
    _idx(ip, imgs, 2051)
    _idx(lp, labels, 2049)
    for cls in ("MNIST", "FashionMNIST"):
        a = getattr(jds, cls)(str(ip), str(lp))
        b = getattr(tds, cls)(str(ip), str(lp), transform=tT.ToTensor())
        assert len(b) == len(a) == 6
        for i in range(6):
            np.testing.assert_array_equal(b.images[i], a.images[i])
            assert b[i][1] == a[i][1]
            np.testing.assert_allclose(
                b[i][0].numpy(), _np(jT.ToTensor()(a[i][0])), atol=1e-6)
    with pytest.raises(FileNotFoundError):
        tds.MNIST(str(tmp_path / "missing.gz"), str(lp))


def _cifar_tar(path, members, label_key, n=4, seed=0):
    rng = np.random.default_rng(seed)
    with tarfile.open(path, "w:gz") as tar:
        for i, name in enumerate(members):
            d = {b"data": rng.integers(0, 256, (n, 3072)).astype(np.uint8),
                 label_key: list(rng.integers(0, 100, n).tolist())}
            blob = pickle.dumps(d)
            info = tarfile.TarInfo(f"cifar/{name}")
            info.size = len(blob)
            tar.addfile(info, io.BytesIO(blob))


def test_cifar10_from_a_local_archive(tmp_path):
    path = str(tmp_path / "cifar-10-python.tar.gz")
    _cifar_tar(path, [f"data_batch_{i}" for i in range(1, 6)]
               + ["test_batch"], b"labels")
    for mode, n in (("train", 20), ("test", 4)):
        a, b = jds.Cifar10(path, mode), tds.Cifar10(path, mode)
        assert len(b) == len(a) == n
        for i in (0, n - 1):
            np.testing.assert_array_equal(b[i][0], a[i][0])
            assert b[i][1] == a[i][1]
    with pytest.raises(FileNotFoundError):
        tds.Cifar10(str(tmp_path / "none.tar.gz"))


def test_reference_fault_cifar100_reads_the_cifar100_archive(tmp_path):
    """Paddle's Cifar100 reads ``cifar-100-python.tar.gz`` (members
    ``train`` and ``test``, the fine labels); the reference's is Cifar10
    under another name and finds no member of that archive."""
    path = str(tmp_path / "cifar-100-python.tar.gz")
    _cifar_tar(path, ["train", "test"], b"fine_labels", n=5)
    b = tds.Cifar100(path, "train")
    assert len(b) == 5 and 0 <= int(b[0][1]) < 100
    assert b[0][0].shape == (3, 32, 32)
    assert len(tds.Cifar100(path, "test")) == 5
    with pytest.raises(ValueError):  # no member: nothing to concatenate
        jds.Cifar100(path, "train")


def _sync_bn_rank(x, w, C):
    import torch

    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import get_rank

    torch.manual_seed(0)
    r = get_rank()
    bn = nn.SyncBatchNorm(C, momentum=0.8)
    with torch.no_grad():
        bn.weight.copy_(torch.arange(1.0, C + 1))
        bn.bias.copy_(torch.arange(C) * 0.1)
    half = x.shape[0] // 2
    xr = torch.from_numpy(x[r * half:(r + 1) * half]).requires_grad_()
    outs = []
    for _ in range(2):  # two updates of the running statistics
        out = bn(xr)
        (out * torch.from_numpy(w[r * half:(r + 1) * half])).sum().backward()
        outs.append(out.detach().numpy())
    return (outs, xr.grad.numpy(), bn.weight.grad.numpy(),
            bn.bias.grad.numpy(), bn._mean.numpy(), bn._variance.numpy())


def test_sync_batch_norm_two_ranks_equals_whole_batch(tmp_path):
    from paddle_tpu_torch import nn

    C = 3
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, C, 3, 2)) * 2 + 1).astype(np.float32)
    w = rng.standard_normal((4, C, 3, 2)).astype(np.float32)
    world = World(2, tmp_path)
    try:
        ranks = world.run(_sync_bn_rank, x, w, C)
    finally:
        world.close()
    bn = nn.BatchNorm2D(C, momentum=0.8)
    with torch.no_grad():
        bn.weight.copy_(torch.arange(1.0, C + 1))
        bn.bias.copy_(torch.arange(C) * 0.1)
    xt = torch.from_numpy(x).requires_grad_()
    outs = []
    for _ in range(2):
        out = bn(xt)
        (out * torch.from_numpy(w)).sum().backward()
        outs.append(out.detach().numpy())
    tol = dict(atol=1e-5, rtol=1e-5)
    for k in range(2):
        np.testing.assert_allclose(
            np.concatenate([r[0][k] for r in ranks]), outs[k], **tol)
    np.testing.assert_allclose(np.concatenate([r[1] for r in ranks]),
                               xt.grad.numpy(), **tol)
    np.testing.assert_allclose(sum(r[2] for r in ranks),
                               bn.weight.grad.numpy(), **tol)
    np.testing.assert_allclose(sum(r[3] for r in ranks),
                               bn.bias.grad.numpy(), **tol)
    for r in ranks:
        np.testing.assert_allclose(r[4], bn._mean.numpy(), **tol)
        np.testing.assert_allclose(r[5], bn._variance.numpy(), **tol)


def test_vision_exports_the_reference_names():
    """``vision.models``, ``transforms`` and ``datasets`` have every public
    name of the reference's (``vision.ops`` waits for ROADMAP item 12b)."""
    import paddle_tpu.vision.models as jmodels
    from paddle_tpu_torch.vision import models as tmodels

    public = [n for n in dir(jmodels) if not n.startswith("_")]
    assert [n for n in public if not hasattr(tmodels, n)] == []
    assert [n for n in jT.__all__ if not hasattr(tT, n)] == []
    assert [n for n in jds.__all__ if not hasattr(tds, n)] == []
