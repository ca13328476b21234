"""Vectorized numpy augmentations: a copy of the JAX package's
``data/augment.py``.

- MNIST and Digits: normalize (0.1307, 0.3081)
- CIFAR-10/100 train: pad-4 reflect -> random crop 32 -> random hflip ->
  normalize mean [125.3,123.0,113.9]/255, std [63.0,62.1,66.7]/255
- SVHN train: pad-4 zeros -> random crop 32 -> hflip -> normalize
  (0.4914,0.4822,0.4465)/(0.2023,0.1994,0.2010)
- ImageNet geometry (``RRC_STACKS``): random-resized-crop from the 256 px
  store (area and aspect jitter, integer fixed-point bilinear resize to
  224, hflip) on train batches, a center crop on eval batches, then the
  ImageNet constants.

The crop draws (ys, xs, flip, in that order, from one numpy Generator) are
the JAX package's, so a seed gives the same bytes in both packages. The
RRC rectangles come from a counter-based stream (splitmix64 of the seed
and a per-image counter) and the resize is integer arithmetic, so the
port's RRC bytes equal the JAX package's bit for bit. The resize runs in
the native OpenMP kernel ``psl_rrc_batch`` of ``native/loader.cpp``, which
the port compiles into its own ``build/`` directory at first use
(``_load_native_loader``), or, where no compiler is found, in
``_rrc_numpy``, the same arithmetic in numpy. ``rrc_backend()`` says which.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

MNIST_MEAN, MNIST_STD = (0.1307,), (0.3081,)
CIFAR_MEAN = np.array([125.3, 123.0, 113.9], np.float32) / 255.0
CIFAR_STD = np.array([63.0, 62.1, 66.7], np.float32) / 255.0
SVHN_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
SVHN_STD = np.array([0.2023, 0.1994, 0.2010], np.float32)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

# Crop-augmented datasets -> (pad, np.pad mode).
CROP_STACKS = {
    "Cifar10": (4, "reflect"),
    "Cifar100": (4, "reflect"),
    "synthetic_cifar10": (4, "reflect"),
    "SVHN": (4, "constant"),
}

# RRC-augmented datasets -> (scale range, aspect-ratio range). The output
# geometry is datasets.DATASET_SHAPES' (the model-facing shape), the
# storage datasets._STORAGE_HW's.
RRC_STACKS = {
    "ImageNet": ((0.08, 1.0), (3.0 / 4.0, 4.0 / 3.0)),
    "synthetic_imagenet_rrc": ((0.08, 1.0), (3.0 / 4.0, 4.0 / 3.0)),
}

# ------------------------------------------------------------ native RRC --

REPO = Path(__file__).resolve().parent.parent.parent
LOADER_SRC = REPO / "native" / "loader.cpp"
BUILD = Path(__file__).resolve().parent.parent / "build"
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-fPIC", "-shared")

_loader_lock = threading.Lock()
_loader_lib: Optional[ctypes.CDLL] = None
_loader_tried = False


def _configure_loader(lib: ctypes.CDLL) -> None:
    lib.psl_rrc_batch.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 6
    lib.psl_rrc_batch.restype = None


def _loader_target(cxx: str) -> Path:
    """``build/libpsloader-<hash>.so``: the hash covers the source, the
    flags and what ``-march=native`` means to this compiler on this host,
    so a build for another CPU is never loaded."""
    native = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                            capture_output=True, timeout=60)
    h = hashlib.sha256(LOADER_SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(native.stdout)
    return BUILD / f"libpsloader-{h.hexdigest()[:16]}.so"


def _load_native_loader() -> Optional[ctypes.CDLL]:
    """The native RRC kernel (``native/loader.cpp``), compiled at first use
    with ``g++ -O3 -march=native -fopenmp -fPIC -shared`` into ``build/``
    (nothing is written under ``native/``); None where no compiler is
    found or the build fails, and then ``rrc_batch`` runs ``_rrc_numpy``,
    which is bitwise the same."""
    global _loader_lib, _loader_tried
    with _loader_lock:
        if _loader_tried:
            return _loader_lib
        _loader_tried = True
        cxx = shutil.which("g++")
        if cxx is None:
            return None
        try:
            out = _loader_target(cxx)
            if not out.exists():
                BUILD.mkdir(parents=True, exist_ok=True)
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run([cxx, *CXX_FLAGS, str(LOADER_SRC), "-o",
                                str(tmp)], capture_output=True, timeout=300,
                               check=True)
                tmp.replace(out)
            lib = ctypes.CDLL(str(out))
            _configure_loader(lib)
        except (OSError, subprocess.SubprocessError, AttributeError):
            return None
        _loader_lib = lib
        return lib


def rrc_backend() -> str:
    """``"native"`` when ``rrc_batch`` runs the compiled kernel, else
    ``"numpy"``."""
    return "numpy" if _load_native_loader() is None else "native"


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


# --------------------------------------------- random-resized-crop (RRC) --
# ``ps_pytorch_tpu/data/augment.py:162-358``: torchvision's protocol for
# the rectangles, drawn from a counter-based stream, and a separable
# bilinear resize in integer fixed point (RRC_SHIFT fractional bits an
# axis), the arithmetic of ``native/loader.cpp:psl_rrc_batch``.

RRC_SHIFT = 10                      # fixed-point fractional bits per axis
_RRC_ONE = 1 << RRC_SHIFT
_RRC_ATTEMPTS = 10                  # torchvision RandomResizedCrop protocol


def _mix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer over uint64 (wraps mod 2^64)."""
    with np.errstate(over="ignore"):
        x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
        x ^= x >> np.uint64(30)
        x = (x * np.uint64(0xBF58476D1CE4E5B9)).astype(np.uint64)
        x ^= x >> np.uint64(27)
        x = (x * np.uint64(0x94D049BB133111EB)).astype(np.uint64)
        return x ^ (x >> np.uint64(31))


def _counter_uniforms(seed: int, counters: np.ndarray, n: int) -> np.ndarray:
    """[B, n] uniforms in [0,1), each a pure function of (seed, counter, j)."""
    c = np.asarray(counters, np.uint64)
    with np.errstate(over="ignore"):
        base = _mix64(c ^ _mix64(np.uint64(0xABCD) + np.uint64(seed)))
        js = (np.arange(1, n + 1, dtype=np.uint64)
              * np.uint64(0x9E3779B97F4A7C15))
        bits = _mix64(base[:, None] + js[None, :])
    return (bits >> np.uint64(11)).astype(np.float64) * (2.0 ** -53)


def rrc_params(seed: int, counters: np.ndarray, src_h: int, src_w: int,
               scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0)):
    """torchvision's RandomResizedCrop rectangles and the hflips for a
    batch: up to 10 attempts of (area uniform in scale * src_area, aspect
    log-uniform in ratio), the first in bounds wins, else a center crop at
    the nearest aspect in range. A (seed, counter) gives the same rectangle
    in whatever batch it lands. Returns (ys, xs, hs, ws int32[B], flip
    uint8[B]), in bounds with hs, ws >= 1."""
    b = len(counters)
    u = _counter_uniforms(seed, counters, 4 * _RRC_ATTEMPTS + 1)
    area = float(src_h * src_w)
    ua = u[:, 0:4 * _RRC_ATTEMPTS:4]            # [B, attempts]
    ur = u[:, 1:4 * _RRC_ATTEMPTS:4]
    uy = u[:, 2:4 * _RRC_ATTEMPTS:4]
    ux = u[:, 3:4 * _RRC_ATTEMPTS:4]
    target = area * (scale[0] + (scale[1] - scale[0]) * ua)
    log_r = np.log(ratio[0]) + (np.log(ratio[1]) - np.log(ratio[0])) * ur
    ar = np.exp(log_r)
    ws_c = np.round(np.sqrt(target * ar)).astype(np.int64)
    hs_c = np.round(np.sqrt(target / ar)).astype(np.int64)
    ok = (ws_c > 0) & (ws_c <= src_w) & (hs_c > 0) & (hs_c <= src_h)
    first = np.argmax(ok, axis=1)               # first valid attempt
    rows = np.arange(b)
    hs = hs_c[rows, first]
    ws = ws_c[rows, first]
    ys = np.floor(uy[rows, first] * (src_h - hs + 1)).astype(np.int64)
    xs = np.floor(ux[rows, first] * (src_w - ws + 1)).astype(np.int64)
    none_ok = ~ok.any(axis=1)
    if none_ok.any():
        in_ratio = src_w / src_h
        if in_ratio < ratio[0]:
            fw, fh = src_w, min(int(round(src_w / ratio[0])), src_h)
        elif in_ratio > ratio[1]:
            fh, fw = src_h, min(int(round(src_h * ratio[1])), src_w)
        else:
            fw, fh = src_w, src_h
        hs = np.where(none_ok, fh, hs)
        ws = np.where(none_ok, fw, ws)
        ys = np.where(none_ok, (src_h - fh) // 2, ys)
        xs = np.where(none_ok, (src_w - fw) // 2, xs)
    hs = np.maximum(hs, 1)
    ws = np.maximum(ws, 1)
    flip = (u[:, 4 * _RRC_ATTEMPTS] < 0.5).astype(np.uint8)
    return (ys.astype(np.int32), xs.astype(np.int32),
            hs.astype(np.int32), ws.astype(np.int32), flip)


def _rrc_axis_tables(crop: int, out: int):
    """Fixed-point bilinear sampling tables of one axis (half-pixel
    centres, clamped at the edge): (i0, i1, w0, w1), w0 + w1 == 1 <<
    RRC_SHIFT; the integer expressions of ``psl_axis_tables``."""
    t = np.arange(out, dtype=np.int64)
    num = (2 * t + 1) * crop - out
    fp = np.where(num > 0, (num << RRC_SHIFT) // (2 * out), 0)
    i0 = fp >> RRC_SHIFT
    fr = fp & (_RRC_ONE - 1)
    at_edge = i0 >= crop - 1
    i0 = np.where(at_edge, crop - 1, i0)
    fr = np.where(at_edge, 0, fr)
    i1 = np.minimum(i0 + 1, crop - 1)
    return (i0.astype(np.int64), i1.astype(np.int64),
            (_RRC_ONE - fr).astype(np.int32), fr.astype(np.int32))


def _rrc_numpy(src, sel, ys, xs, hs, ws, flip, oh, ow, out):
    """The plain version of ``psl_rrc_batch``: per image, the separable
    fixed-point bilinear resize with int32 sums and the flip as mirrored
    column tables; bitwise the native kernel."""
    for i in range(len(sel)):
        ch, cw = int(hs[i]), int(ws[i])
        crop = src[sel[i], ys[i]:ys[i] + ch,
                   xs[i]:xs[i] + cw].astype(np.int32)
        xi0, xi1, wx0, wx1 = _rrc_axis_tables(cw, ow)
        if flip[i]:
            xi0, xi1 = xi0[::-1], xi1[::-1]
            wx0, wx1 = wx0[::-1], wx1[::-1]
        yi0, yi1, wy0, wy1 = _rrc_axis_tables(ch, oh)
        # Horizontal pass: [ch, ow, C] int32, values <= 255 << RRC_SHIFT.
        hbuf = (wx0[None, :, None] * crop[:, xi0]
                + wx1[None, :, None] * crop[:, xi1])
        v = (wy0[:, None, None].astype(np.int32) * hbuf[yi0]
             + wy1[:, None, None].astype(np.int32) * hbuf[yi1]
             + (1 << (2 * RRC_SHIFT - 1)))
        out[i] = (v >> (2 * RRC_SHIFT)).astype(np.uint8)
    return out


def rrc_batch(src: np.ndarray, sel: np.ndarray, ys, xs, hs, ws, flip,
              oh: int, ow: int) -> np.ndarray:
    """Gather, crop, bilinear resize and hflip in one pass: src [N,SH,SW,C]
    uint8 -> [B,oh,ow,C] uint8. The native kernel where it is built (and
    the store is contiguous uint8), else ``_rrc_numpy``."""
    b, c = len(sel), src.shape[-1]
    out = np.empty((b, oh, ow, c), np.uint8)
    lib = _load_native_loader()
    if lib is not None and src.dtype == np.uint8 and src.flags.c_contiguous:
        sel64 = np.ascontiguousarray(sel, np.int64)
        ys32 = np.ascontiguousarray(ys, np.int32)
        xs32 = np.ascontiguousarray(xs, np.int32)
        hs32 = np.ascontiguousarray(hs, np.int32)
        ws32 = np.ascontiguousarray(ws, np.int32)
        fl8 = np.ascontiguousarray(flip, np.uint8)
        lib.psl_rrc_batch(
            src.ctypes.data, sel64.ctypes.data, ys32.ctypes.data,
            xs32.ctypes.data, hs32.ctypes.data, ws32.ctypes.data,
            fl8.ctypes.data, out.ctypes.data,
            b, src.shape[1], src.shape[2], c, oh, ow)
        return out
    if src.dtype != np.uint8:
        src = src.astype(np.uint8)  # contract: uint8 in, uint8 out
    return _rrc_numpy(src, sel, ys, xs, hs, ws, flip, oh, ow, out)


def random_resized_crop(src: np.ndarray, sel: np.ndarray,
                        counters: np.ndarray, seed: int, oh: int, ow: int,
                        scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0)
                        ) -> np.ndarray:
    """Draw (counter-based) and run the RRC of a batch of source indices:
    src [N,SH,SW,C] uint8 -> [B,oh,ow,C] uint8."""
    ys, xs, hs, ws, flip = rrc_params(seed, counters, src.shape[1],
                                      src.shape[2], scale, ratio)
    return rrc_batch(src, sel, ys, xs, hs, ws, flip, oh, ow)


def center_crop(x: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """The eval geometry of the RRC sets: the center oh x ow of the
    decode-sized store (256 -> 224)."""
    h, w = x.shape[1], x.shape[2]
    if (h, w) == (oh, ow):
        return x
    y0, x0 = (h - oh) // 2, (w - ow) // 2
    return x[:, y0:y0 + oh, x0:x0 + ow]


def norm_constants_for(dataset: str):
    """(mean, std) of the host normalize stack, or None."""
    if dataset in ("MNIST", "Digits"):
        return MNIST_MEAN, MNIST_STD
    if dataset in ("Cifar10", "Cifar100", "synthetic_cifar10"):
        return CIFAR_MEAN, CIFAR_STD
    if dataset == "SVHN":
        return SVHN_MEAN, SVHN_STD
    if dataset in ("ImageNet", "synthetic_imagenet_rrc"):
        # Plain ``synthetic_imagenet`` stays without constants, as in the
        # JAX package (its augment-free bench row).
        return IMAGENET_MEAN, IMAGENET_STD
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
