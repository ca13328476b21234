"""Dataset registry and the prefetching loader: a copy of the JAX
package's ``data/datasets.py``, its worker pool (``loader_workers``)
included.

For the same seed the loader yields the same bytes as the JAX package's
loader at the same worker count: the same shuffle
(``default_rng((seed, epoch))``), the same augment stream
(``default_rng((seed, epoch, host, 7))`` with one worker,
``default_rng((seed, epoch, host, 7, batch))`` a batch with several) and
the same draw order, and for the RRC sets the same counter-based
rectangles and integer resize at any worker count.
"""

import os
import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

from ps_pytorch_tpu_torch.data import augment

# dataset -> (H, W, C, num_classes, train_size_hint)
DATASET_SHAPES = {
    "MNIST": (28, 28, 1, 10, 60000),
    # UCI digits (shipped with the port) upsampled to MNIST geometry.
    "Digits": (28, 28, 1, 10, 1437),
    "Cifar10": (32, 32, 3, 10, 50000),
    "Cifar100": (32, 32, 3, 100, 50000),
    "synthetic": (32, 32, 3, 10, 50000),
    "synthetic_mnist": (28, 28, 1, 10, 60000),
    # Synthetic uint8 images through the real CIFAR augment stack.
    "synthetic_cifar10": (32, 32, 3, 10, 50000),
    "synthetic_cifar100": (32, 32, 3, 100, 50000),
    "SVHN": (32, 32, 3, 10, 73257),
    # ImageNet-shaped synthetic sets (ResNet-50 at 224 px): float images
    # without augment, and 256 px uint8 storage through the RRC stack.
    "synthetic_imagenet": (224, 224, 3, 1000, 512),
    "synthetic_imagenet_rrc": (224, 224, 3, 1000, 512),
}

# Datasets whose stored images are larger than the model-facing shape: the
# RRC sets store 256 px, and the loader's RRC (train) or center crop (eval)
# gives the 224 px of DATASET_SHAPES.
_STORAGE_HW = {
    "ImageNet": (256, 256),
    "synthetic_imagenet_rrc": (256, 256),
}


def sample_shape(dataset: str) -> Tuple[int, int, int]:
    """(H, W, C) of one example."""
    h, w, c, _, _ = DATASET_SHAPES[dataset]
    return (h, w, c)


def _load_files(name: str, root: str, train: bool):
    from ps_pytorch_tpu_torch.data import vision_io

    if name == "MNIST":
        x, y = vision_io.load_mnist(root, train)
    elif name == "Cifar10":
        x, y = vision_io.load_cifar10(root, train)
    elif name == "Cifar100":
        x, y = vision_io.load_cifar100(root, train)
    elif name == "SVHN":
        x, y = vision_io.load_svhn(root, train)
    elif name == "Digits":
        x, y = vision_io.load_digits28(train)
    else:
        raise ValueError(name)
    return x.astype(np.uint8, copy=False), y.astype(np.int32)


def _synthetic(name: str, train: bool, seed: int = 0):
    h, w, c, ncls, n = DATASET_SHAPES[name]
    h, w = _STORAGE_HW.get(name, (h, w))
    if not train:
        # About a sixth of train, at least 1000, never more than train.
        n = max(n // 6, min(1000, n))
    rng = np.random.default_rng(seed + (0 if train else 1))
    # Class-dependent means make the task learnable.
    y = rng.integers(0, ncls, size=n).astype(np.int32)
    x = rng.normal(0.5, 0.25, size=(n, h, w, c)).astype(np.float32)
    x += (y[:, None, None, None].astype(np.float32) / ncls - 0.5) * 0.5
    x = np.clip(x, 0.0, 1.0)
    if name == "synthetic_cifar10" or name in augment.RRC_STACKS:
        x = (x * 255.0).astype(np.uint8)
    return x, y


def load_arrays(dataset: str, data_dir: str = "./data", train: bool = True,
                seed: int = 0):
    """-> (x [N,H,W,C], y [N] int32), unnormalized."""
    if dataset.startswith("synthetic"):
        return _synthetic(dataset, train, seed)
    return _load_files(dataset, data_dir, train)


class DataLoader:
    """Sharded, shuffled, augmented batch iterator with one prefetch
    thread, or a pool of ``workers`` threads (``_epoch_pool``).
    ``next_batch`` yields forever, advancing epochs."""

    def __init__(self, x: np.ndarray, y: np.ndarray, batch_size: int,
                 dataset: str = "synthetic", train: bool = True,
                 shuffle: Optional[bool] = None, seed: int = 0,
                 host_id: int = 0, num_hosts: int = 1, prefetch: int = 2,
                 drop_last: bool = True, device_normalize: bool = False,
                 workers: int = 1):
        if len(x) != len(y):
            raise ValueError(f"{len(x)} images but {len(y)} labels")
        self.x, self.y = x, y
        self.dataset = dataset
        self.train = train
        self.device_normalize = device_normalize
        self.shuffle = train if shuffle is None else shuffle
        self.seed = seed
        self.host_id, self.num_hosts = host_id, num_hosts
        self.prefetch = prefetch
        self.drop_last = drop_last
        # workers > 1 assembles batches on a thread pool (the native RRC
        # kernel and numpy's gathers release the interpreter lock); 0 is
        # one worker a CPU.
        self.workers = max(1, workers if workers > 0
                           else (os.cpu_count() or 1))
        if batch_size % num_hosts != 0:
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"{num_hosts} hosts")
        self.local_batch = batch_size // num_hosts
        self.shard_size = len(x) // num_hosts
        if drop_last and self.shard_size < self.local_batch:
            raise ValueError(
                f"per-host shard ({self.shard_size} samples) smaller than "
                f"local batch ({self.local_batch}); next_batch would never "
                "yield")
        # Crop-augmented train data is padded once; each batch is then one
        # strided copy per image from the padded store.
        self._padded = None
        if train and dataset in augment.CROP_STACKS:
            self._padded = augment.pad_images(x, *augment.CROP_STACKS[dataset])
        # RRC sets: RRC from the decode-sized store on train batches, a
        # center crop on eval batches, to the model-facing shape.
        self._rrc = augment.RRC_STACKS.get(dataset) if train else None
        if dataset in DATASET_SHAPES:
            self._out_h, self._out_w, _ = sample_shape(dataset)
        else:
            self._out_h, self._out_w = x.shape[1], x.shape[2]
        self._epoch_iter = None
        self._epoch = 0

    def __len__(self):
        n = self.shard_size // self.local_batch
        if not self.drop_last and self.shard_size % self.local_batch:
            n += 1
        return n

    def _epoch_order(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.x))
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(idx)
        lo = self.host_id * self.shard_size
        return idx[lo:lo + self.shard_size]

    def _assemble(self, b: int, order: np.ndarray, epoch: int,
                  aug_rng) -> Tuple[np.ndarray, np.ndarray]:
        sel = order[b * self.local_batch:(b + 1) * self.local_batch]
        norm_out = not self.device_normalize
        mean_std = augment.norm_constants_for(self.dataset)
        if self._rrc is not None:
            # The rectangles' stream is counter-based: counter = epoch * N
            # + sample, whatever batch the sample lands in.
            scale, ratio = self._rrc
            counters = (np.uint64(epoch) * np.uint64(len(self.x))
                        + sel.astype(np.uint64))
            xb = augment.random_resized_crop(
                self.x, sel, counters, self.seed, self._out_h, self._out_w,
                scale, ratio)
            if norm_out and mean_std is not None:
                xb = augment.normalize(xb, *mean_std)
        elif self._padded is not None:
            xb = augment.crop_flip_prepadded(
                self._padded, sel, aug_rng, self._out_h, self._out_w)
            if norm_out and mean_std is not None:
                xb = augment.normalize(xb, *mean_std)
        elif self.train:
            xb = augment.augment_train(self.x[sel], self.dataset, aug_rng,
                                       normalize_out=norm_out)
        else:
            xb = self.x[sel]
            if self.dataset in augment.RRC_STACKS:
                xb = augment.center_crop(xb, self._out_h, self._out_w)
            xb = augment.transform_test(xb, self.dataset,
                                        normalize_out=norm_out)
        return xb, self.y[sel]

    def epoch(self, epoch: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield (x, y) local batches for one epoch, prefetched."""
        order = self._epoch_order(epoch)
        n = len(self)
        if self.workers > 1:
            yield from self._epoch_pool(order, epoch, n)
            return
        aug_rng = np.random.default_rng((self.seed, epoch, self.host_id, 7))
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        abandoned = threading.Event()

        def _put(item) -> bool:
            # Gives up once the consumer went away, so an abandoned
            # generator does not leave a producer blocked for ever.
            while not abandoned.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for b in range(n):
                    if not _put(self._assemble(b, order, epoch, aug_rng)):
                        return
                _put(None)
            except BaseException as e:  # handed to the consumer, re-raised there
                _put(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            abandoned.set()

    def _epoch_pool(self, order: np.ndarray, epoch: int,
                    n: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """One epoch on ``workers`` threads: each claims the next batch
        index, assembles it with a generator of its own,
        ``default_rng((seed, epoch, host_id, 7, b))`` (so the crop / flip
        draws differ from the one-worker stream; the RRC rectangles are
        counter-based and do not), and parks it; batches are handed out
        in order. At most ``prefetch + workers`` batches are claimed ahead
        of the consumer. A worker's exception is raised in the consumer;
        leaving the generator early releases the workers."""
        window = self.prefetch + self.workers
        cv = threading.Condition()
        state = {"claim": 0, "emit": 0, "abandoned": False, "error": None}
        done: dict = {}

        def work():
            while True:
                with cv:
                    while (state["claim"] - state["emit"] >= window
                           and not state["abandoned"]
                           and state["error"] is None):
                        cv.wait()
                    if (state["abandoned"] or state["error"] is not None
                            or state["claim"] >= n):
                        return
                    b = state["claim"]
                    state["claim"] += 1
                try:
                    rng = np.random.default_rng(
                        (self.seed, epoch, self.host_id, 7, b))
                    item = self._assemble(b, order, epoch, rng)
                except BaseException as e:
                    with cv:
                        state["error"] = e
                        cv.notify_all()
                    return
                with cv:
                    done[b] = item
                    cv.notify_all()

        threads = [threading.Thread(target=work, daemon=True)
                   for _ in range(min(self.workers, max(n, 1)))]
        for t in threads:
            t.start()
        try:
            for b in range(n):
                with cv:
                    while b not in done and state["error"] is None:
                        cv.wait()
                    if state["error"] is not None:
                        raise state["error"]
                    item = done.pop(b)
                    state["emit"] = b + 1
                    cv.notify_all()
                yield item
        finally:
            with cv:
                state["abandoned"] = True
                cv.notify_all()
            for t in threads:
                t.join(timeout=5.0)

    def next_batch(self):
        while True:
            if self._epoch_iter is None:
                self._epoch_iter = self.epoch(self._epoch)
            try:
                return next(self._epoch_iter)
            except StopIteration:
                self._epoch += 1
                self._epoch_iter = None

    def fast_forward(self, n_batches: int) -> None:
        """Position the stream as if ``n_batches`` had been drawn, so a run
        resumed at step k sees the batch an uninterrupted run sees at step
        k+1. Whole epochs are skipped (an epoch's order is a function of
        its index); the rest is drawn batch by batch to keep the augment
        stream in step."""
        per_epoch = len(self)
        if n_batches <= 0 or per_epoch <= 0:
            return
        self._epoch = n_batches // per_epoch
        self._epoch_iter = None
        for _ in range(n_batches % per_epoch):
            self.next_batch()


def prepare_data(cfg, host_id: int = 0,
                 num_hosts: int = 1) -> Tuple[DataLoader, DataLoader]:
    """Config -> (train_loader, test_loader). With cfg.device_normalize on
    (and constants for the dataset) the loaders ship raw uint8 batches."""
    dev_norm = augment.input_norm_for(cfg) is not None
    xtr, ytr = load_arrays(cfg.dataset, cfg.data_dir, train=True,
                           seed=cfg.seed)
    xte, yte = load_arrays(cfg.dataset, cfg.data_dir, train=False,
                           seed=cfg.seed)
    train = DataLoader(xtr, ytr, cfg.batch_size, cfg.dataset, train=True,
                       seed=cfg.seed, host_id=host_id, num_hosts=num_hosts,
                       device_normalize=dev_norm,
                       workers=cfg.loader_workers)
    test = DataLoader(xte, yte, cfg.test_batch_size, cfg.dataset,
                      train=False, shuffle=False, seed=cfg.seed,
                      drop_last=False, device_normalize=dev_norm)
    return train, test
