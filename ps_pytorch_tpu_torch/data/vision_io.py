"""Dataset file parsers (no torchvision): MNIST IDX files, the CIFAR
python pickle batches and SVHN's ``.mat`` files, as the files sit on disk,
and the UCI digits that ship with the port. A copy of the JAX package's
``data/vision_io.py``.

All loaders return ``(x uint8 [N,H,W,C], y int32 [N])``.
"""

import gzip
import os
import pickle
import struct
from typing import Tuple

import numpy as np


def _open_maybe_gz(path: str):
    if os.path.exists(path):
        return open(path, "rb")
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    raise FileNotFoundError(f"{path}[.gz] not found (training never "
                            "downloads: place the dataset files first)")


def read_idx(path: str) -> np.ndarray:
    """Parse one IDX file (the MNIST container format)."""
    with _open_maybe_gz(path) as f:
        magic = struct.unpack(">I", f.read(4))[0]
        dtype_code = (magic >> 8) & 0xFF
        ndim = magic & 0xFF
        if dtype_code != 0x08:  # uint8, the only code MNIST uses
            raise ValueError(
                f"unsupported IDX dtype 0x{dtype_code:02x} in {path}")
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def load_mnist(root: str, train: bool) -> Tuple[np.ndarray, np.ndarray]:
    base = os.path.join(root, "MNIST", "raw")
    split = "train" if train else "t10k"
    x = read_idx(os.path.join(base, f"{split}-images-idx3-ubyte"))[..., None]
    y = read_idx(os.path.join(base, f"{split}-labels-idx1-ubyte"))
    return x, y.astype(np.int32)


def _cifar_pickle(path: str) -> dict:
    # The CIFAR batches are pickles by format: load only files placed on
    # disk from the dataset's own distribution.
    with _open_maybe_gz(path) as f:
        return pickle.load(f, encoding="latin1")


def load_cifar10(root: str, train: bool) -> Tuple[np.ndarray, np.ndarray]:
    base = os.path.join(root, "cifar-10-batches-py")
    names = ([f"data_batch_{i}" for i in range(1, 6)] if train
             else ["test_batch"])
    xs, ys = [], []
    for n in names:
        d = _cifar_pickle(os.path.join(base, n))
        xs.append(np.asarray(d["data"], np.uint8))
        ys.append(np.asarray(d["labels"], np.int32))
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return x, np.concatenate(ys)


def load_cifar100(root: str, train: bool) -> Tuple[np.ndarray, np.ndarray]:
    base = os.path.join(root, "cifar-100-python")
    d = _cifar_pickle(os.path.join(base, "train" if train else "test"))
    x = np.asarray(d["data"], np.uint8).reshape(-1, 3, 32, 32)
    return x.transpose(0, 2, 3, 1), np.asarray(d["fine_labels"], np.int32)


def load_svhn(root: str, train: bool) -> Tuple[np.ndarray, np.ndarray]:
    """``{train,test}_32x32.mat`` (no SVHN data ships with the repo)."""
    from scipy.io import loadmat
    split = "train" if train else "test"
    d = loadmat(os.path.join(root, f"{split}_32x32.mat"))
    x = d["X"].transpose(3, 0, 1, 2).astype(np.uint8)   # HWCN -> NHWC
    y = d["y"].ravel().astype(np.int32)
    y[y == 10] = 0   # SVHN labels digits 1..10 with '0' stored as 10
    return x, y


# ---- Digits (real data that ships with the port) ----

DIGITS_CSV = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "digits.csv.gz")
DIGITS_TRAIN = 1437   # 80% of 1797, fixed seeded split


def _nn_resize(x: np.ndarray, hw: int) -> np.ndarray:
    idx = (np.arange(hw) * x.shape[1]) // hw
    return x[:, idx][:, :, idx]


def load_digits28(train: bool, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """UCI handwritten digits as 28x28x1 uint8: the nearest-neighbour
    upsample of the 8x8 scans, pixel range 0-16 rescaled to 0-255, split
    1437/360 by a seeded permutation, as the JAX package's
    ``load_digits28``. ``digits.csv.gz`` is scikit-learn 1.9.0's bundled
    copy (BSD-3; the data is UCI's): 1797 rows of 64 pixels and a label."""
    with gzip.open(DIGITS_CSV, "rt") as f:
        data = np.loadtxt(f, delimiter=",")
    images = data[:, :-1].reshape(-1, 8, 8)
    x = _nn_resize(images, 28)
    x = np.clip(x * (255.0 / 16.0), 0, 255).astype(np.uint8)[..., None]
    y = data[:, -1].astype(np.int32)
    order = np.random.default_rng(seed).permutation(len(x))
    sel = order[:DIGITS_TRAIN] if train else order[DIGITS_TRAIN:]
    return x[sel], y[sel]
