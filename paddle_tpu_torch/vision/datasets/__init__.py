"""Vision datasets (counterpart of paddle_tpu/vision/datasets) over the
port's ``io.Dataset``: ``FakeData`` (seeded synthetic images, what the
benchmarks train on) and MNIST / FashionMNIST / Cifar10 / Cifar100 parsed
from local files. Nothing is downloaded: without the file they raise
``FileNotFoundError``. Default places: ``$MNIST_DATA_HOME`` and
``$CIFAR_DATA_HOME``, else under ``~/.cache/paddle_tpu``.

Cifar100 reads ``cifar-100-python.tar.gz`` (members ``train`` and
``test``, the fine labels), as Paddle does; the reference's reads the
CIFAR-10 archive (ROADMAP queue 3).
"""
from __future__ import annotations

import gzip
import os
import pickle
import tarfile

import numpy as np

from ...io import Dataset

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100", "FakeData"]


class FakeData(Dataset):
    """Deterministic synthetic images: item ``i`` is drawn from numpy's
    generator seeded ``seed + i`` (standard-normal float32 pixels, a label
    in ``[0, num_classes)``)."""

    def __init__(self, num_samples=1000, image_shape=(3, 32, 32),
                 num_classes=10, transform=None, seed=0):
        self.num_samples = num_samples
        self.image_shape = tuple(image_shape)
        self.num_classes = num_classes
        self.transform, self.seed = transform, seed

    def __getitem__(self, idx):
        rng = np.random.default_rng(self.seed + idx)
        img = rng.standard_normal(self.image_shape).astype(np.float32)
        label = int(rng.integers(0, self.num_classes))
        if self.transform:
            img = self.transform(img)
        return img, np.int64(label)

    def __len__(self):
        return self.num_samples


def _data_home(env, sub):
    return os.environ.get(env, os.path.expanduser(
        os.path.join("~", ".cache", "paddle_tpu", sub)))


class MNIST(Dataset):
    """The idx files (gzip) of MNIST: 28 x 28 uint8 images, int64
    labels."""

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=False, backend=None):
        self.transform = transform
        base = _data_home("MNIST_DATA_HOME", "mnist")
        prefix = "train" if mode == "train" else "t10k"
        image_path = image_path or os.path.join(
            base, f"{prefix}-images-idx3-ubyte.gz")
        label_path = label_path or os.path.join(
            base, f"{prefix}-labels-idx1-ubyte.gz")
        if not os.path.exists(image_path):
            raise FileNotFoundError(
                f"MNIST files not found at {image_path}; nothing is "
                "downloaded: place the files there or use FakeData")
        with gzip.open(image_path, "rb") as f:
            data = np.frombuffer(f.read(), np.uint8, offset=16)
        self.images = data.reshape(-1, 28, 28)
        with gzip.open(label_path, "rb") as f:
            self.labels = np.frombuffer(f.read(), np.uint8, offset=8)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform:
            img = self.transform(img)
        return img, np.int64(self.labels[idx])

    def __len__(self):
        return len(self.images)


FashionMNIST = MNIST


class Cifar10(Dataset):
    """The python pickles of a CIFAR archive: 3 x 32 x 32 uint8 images,
    int64 labels."""
    _archive = "cifar-10-python.tar.gz"
    _members = {"train": [f"data_batch_{i}" for i in range(1, 6)],
                "test": ["test_batch"]}
    _labels = b"labels"

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=False, backend=None):
        self.transform = transform
        data_file = data_file or os.path.join(
            _data_home("CIFAR_DATA_HOME", "cifar"), self._archive)
        if not os.path.exists(data_file):
            raise FileNotFoundError(
                f"CIFAR archive not found at {data_file}; nothing is "
                "downloaded: place the archive there or use FakeData")
        members = self._members["train" if mode == "train" else "test"]
        xs, ys = [], []
        with tarfile.open(data_file) as tar:
            for m in tar.getmembers():
                if os.path.basename(m.name) in members:
                    d = pickle.load(tar.extractfile(m), encoding="bytes")
                    xs.append(d[b"data"])
                    ys.extend(d[self._labels])
        self.images = np.concatenate(xs).reshape(-1, 3, 32, 32)
        self.labels = np.asarray(ys, np.int64)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform:
            img = self.transform(img)
        return img, self.labels[idx]

    def __len__(self):
        return len(self.images)


class Cifar100(Cifar10):
    _archive = "cifar-100-python.tar.gz"
    _members = {"train": ["train"], "test": ["test"]}
    _labels = b"fine_labels"
