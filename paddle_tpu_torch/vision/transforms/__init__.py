"""Vision transforms (counterpart of paddle_tpu/vision/transforms):
preprocessing on the host in numpy, images HWC, composable with the
DataLoader. ``to_tensor`` / ``ToTensor`` and ``normalize`` / ``Normalize``
return torch tensors (CHW by default); the random transforms draw from
Python's ``random``, as the reference's do."""
from __future__ import annotations

import numbers
import random

import numpy as np
import torch

__all__ = ["Compose", "ToTensor", "Normalize", "Resize", "RandomCrop",
           "CenterCrop", "RandomHorizontalFlip", "RandomVerticalFlip",
           "Transpose", "BrightnessTransform", "Pad", "RandomRotation",
           "to_tensor", "normalize", "resize", "hflip", "vflip", "crop",
           "center_crop"]


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, img):
        for t in self.transforms:
            img = t(img)
        return img


def to_tensor(pic, data_format="CHW"):
    """float32 in [0, 1] (values above 1.5 are read as 0-255 and scaled),
    a 2-D image given one channel, CHW unless ``data_format="HWC"``."""
    arr = np.asarray(pic, np.float32)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.max() > 1.5:
        arr = arr / 255.0
    if data_format == "CHW":
        arr = arr.transpose(2, 0, 1)
    return torch.from_numpy(np.ascontiguousarray(arr))


class ToTensor:
    def __init__(self, data_format="CHW"):
        self.data_format = data_format

    def __call__(self, pic):
        return to_tensor(pic, self.data_format)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    """``(img - mean) / std`` per channel, as a float32 tensor."""
    if isinstance(img, torch.Tensor):
        img = img.numpy()
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    if data_format == "CHW":
        mean, std = mean.reshape(-1, 1, 1), std.reshape(-1, 1, 1)
    return torch.from_numpy((np.asarray(img, np.float32) - mean) / std)


class Normalize:
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False):
        if isinstance(mean, numbers.Number):
            mean = [mean, mean, mean]
        if isinstance(std, numbers.Number):
            std = [std, std, std]
        self.mean, self.std, self.data_format = mean, std, data_format

    def __call__(self, img):
        return normalize(img, self.mean, self.std, self.data_format)


def resize(img, size, interpolation="bilinear"):
    """Nearest-neighbour resize to ``size`` ``(h, w)``; an int sets the
    shorter side, keeping the aspect ratio."""
    arr = np.asarray(img)
    h, w = arr.shape[:2]
    if isinstance(size, int):
        size = (size, int(size * w / h)) if h < w else (int(size * h / w),
                                                       size)
    oh, ow = size
    ys = (np.arange(oh) * (h / oh)).astype(int).clip(0, h - 1)
    xs = (np.arange(ow) * (w / ow)).astype(int).clip(0, w - 1)
    return arr[ys][:, xs]


class Resize:
    def __init__(self, size, interpolation="bilinear"):
        self.size, self.interpolation = size, interpolation

    def __call__(self, img):
        return resize(img, self.size, self.interpolation)


def crop(img, top, left, height, width):
    return np.asarray(img)[top:top + height, left:left + width]


def center_crop(img, output_size):
    arr = np.asarray(img)
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    h, w = arr.shape[:2]
    th, tw = output_size
    return crop(arr, (h - th) // 2, (w - tw) // 2, th, tw)


class CenterCrop:
    def __init__(self, size):
        self.size = size

    def __call__(self, img):
        return center_crop(img, self.size)


class RandomCrop:
    """A ``size`` crop at a random place, after ``padding`` zeros on each
    side."""

    def __init__(self, size, padding=0, pad_if_needed=False):
        self.size = (size, size) if isinstance(size, int) else size
        self.padding = padding

    def __call__(self, img):
        arr = np.asarray(img)
        if self.padding:
            p = self.padding
            arr = np.pad(arr, [(p, p), (p, p)] + [(0, 0)] * (arr.ndim - 2))
        h, w = arr.shape[:2]
        th, tw = self.size
        top = random.randint(0, h - th)
        left = random.randint(0, w - tw)
        return crop(arr, top, left, th, tw)


def hflip(img):
    return np.asarray(img)[:, ::-1]


def vflip(img):
    return np.asarray(img)[::-1]


class RandomHorizontalFlip:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, img):
        return hflip(img) if random.random() < self.prob else np.asarray(img)


class RandomVerticalFlip:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, img):
        return vflip(img) if random.random() < self.prob else np.asarray(img)


class Transpose:
    def __init__(self, order=(2, 0, 1)):
        self.order = order

    def __call__(self, img):
        arr = np.asarray(img)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return arr.transpose(self.order)


class BrightnessTransform:
    """Brightness scaled by a factor drawn in ``1 ± value``, clipped to the
    image's range (0-255, or 0-1)."""

    def __init__(self, value):
        self.value = value

    def __call__(self, img):
        arr = np.asarray(img, np.float32)
        alpha = 1 + random.uniform(-self.value, self.value)
        return np.clip(arr * alpha, 0, 255 if arr.max() > 1.5 else 1.0)


class Pad:
    """``padding`` as an int or ``(left, top, right, bottom)``, filled with
    ``fill``."""

    def __init__(self, padding, fill=0, padding_mode="constant"):
        self.padding, self.fill = padding, fill

    def __call__(self, img):
        arr = np.asarray(img)
        p = self.padding
        if isinstance(p, int):
            p = (p, p, p, p)
        return np.pad(arr, [(p[1], p[3]), (p[0], p[2])] +
                      [(0, 0)] * (arr.ndim - 2), constant_values=self.fill)


class RandomRotation:
    """A rotation by a random multiple of 90 degrees (the reference's
    right-angle stand-in for an arbitrary rotation)."""

    def __init__(self, degrees, **kwargs):
        self.degrees = (-degrees, degrees) if isinstance(
            degrees, numbers.Number) else degrees

    def __call__(self, img):
        k = random.randint(0, 3)
        return np.rot90(np.asarray(img), k=k).copy()
