"""Vectorized numpy augmentations: a copy of the JAX package's
``data/augment.py`` for the sets this slice runs, numpy path only.

- MNIST and Digits: normalize (0.1307, 0.3081)
- CIFAR-10/100 train: pad-4 reflect -> random crop 32 -> random hflip ->
  normalize mean [125.3,123.0,113.9]/255, std [63.0,62.1,66.7]/255

The random draws (ys, xs, flip, in that order, from one numpy Generator)
are the JAX package's, so a seed gives the same bytes in both packages.
"""

from typing import Optional

import numpy as np

MNIST_MEAN, MNIST_STD = (0.1307,), (0.3081,)
CIFAR_MEAN = np.array([125.3, 123.0, 113.9], np.float32) / 255.0
CIFAR_STD = np.array([63.0, 62.1, 66.7], np.float32) / 255.0

# Crop-augmented datasets -> (pad, np.pad mode).
CROP_STACKS = {
    "Cifar10": (4, "reflect"),
    "Cifar100": (4, "reflect"),
    "synthetic_cifar10": (4, "reflect"),
}


def normalize(x: np.ndarray, mean, std) -> np.ndarray:
    """x: [..., C] float in [0,1] OR uint8 in [0,255] -> channel-normalized
    float32 (the uint8 path folds the /255 into the scale)."""
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    if x.dtype == np.uint8:
        out = x * (1.0 / (255.0 * std)).astype(np.float32)
        out -= mean / std
        return out
    return ((x - mean) / std).astype(np.float32)


def crop_flip_prepadded(padded: np.ndarray, sel: np.ndarray,
                        rng: np.random.Generator, h: int, w: int
                        ) -> np.ndarray:
    """Gather + random crop + hflip in one pass over a dataset padded once:
    each output image is one strided copy from the padded store."""
    b = len(sel)
    c = padded.shape[-1]
    ys = rng.integers(0, padded.shape[1] - h + 1, size=b)
    xs = rng.integers(0, padded.shape[2] - w + 1, size=b)
    flip = rng.random(b) < 0.5
    out = np.empty((b, h, w, c), padded.dtype)
    for i in range(b):
        v = padded[sel[i], ys[i]:ys[i] + h, xs[i]:xs[i] + w]
        out[i] = v[:, ::-1] if flip[i] else v
    return out


def pad_images(x: np.ndarray, pad: int, mode: str) -> np.ndarray:
    return np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)), mode=mode)


def norm_constants_for(dataset: str):
    """(mean, std) of the host normalize stack, or None."""
    if dataset in ("MNIST", "Digits"):
        return MNIST_MEAN, MNIST_STD
    if dataset in ("Cifar10", "Cifar100", "synthetic_cifar10"):
        return CIFAR_MEAN, CIFAR_STD
    return None


def augment_train(x: np.ndarray, dataset: str, rng: np.random.Generator,
                  normalize_out: bool = True) -> np.ndarray:
    """Raw batch (uint8 [0,255] or float [0,1]), NHWC -> augmented batch.
    ``normalize_out=False`` keeps the storage dtype for a step that
    normalizes on the device."""
    crop = CROP_STACKS.get(dataset)
    if crop is not None:
        x = crop_flip_prepadded(pad_images(x, *crop), np.arange(len(x)), rng,
                                x.shape[1], x.shape[2])
    ms = norm_constants_for(dataset)
    if ms is None:
        return x.astype(np.float32)
    return normalize(x, *ms) if normalize_out else x


def transform_test(x: np.ndarray, dataset: str,
                   normalize_out: bool = True) -> np.ndarray:
    ms = norm_constants_for(dataset)
    if ms is None:
        return x.astype(np.float32)
    return normalize(x, *ms) if normalize_out else x


def device_norm_constants(dataset: str):
    """(scale[C], shift[C]) with ``raw * scale - shift`` equal to the host
    ``normalize`` of a uint8 batch; None for a dataset without constants."""
    ms = norm_constants_for(dataset)
    if ms is None:
        return None
    mean = np.asarray(ms[0], np.float32)
    std = np.asarray(ms[1], np.float32)
    return ((1.0 / (255.0 * std)).astype(np.float32),
            (mean / std).astype(np.float32))


def input_norm_for(cfg) -> Optional[tuple]:
    """TrainConfig -> on-device normalization constants, or None when the
    host normalizes (device_normalize off, or no constants)."""
    if not cfg.device_normalize:
        return None
    return device_norm_constants(cfg.dataset)
