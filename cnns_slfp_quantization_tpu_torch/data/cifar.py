"""CIFAR-10/100 loading (torchvision's on-disk layout) and batch iterators
(counterpart of the JAX ``data/cifar.py``).

Reads the standard ``cifar-100-python/{train,test}`` (or
``cifar-10-batches-py/{data_batch_1..5,test_batch}``) pickles under
``data_dir``, the files torchvision's ``datasets.CIFAR100`` reads
(cifar100_train_eval.py:96-104).  Nothing is downloaded: point
``data_dir`` at an existing copy, or use :mod:`.synthetic`.

The iterators augment as JAX's do, so that the same seed gives the same
batches in both: with the native library (``utils/native.py``) when it
builds, else with numpy (``transforms.cifar_train`` / ``cifar_eval``).
The two are different streams (the native augmenter draws its crop and
flip from its own generator and normalizes as ``(px - 255 mean) / (255
std)``), so :func:`make_iterators` prints which one runs.
"""

from __future__ import annotations

import pathlib
import pickle
from typing import Iterator

import numpy as np

from cnns_slfp_quantization_tpu_torch.data import transforms
from cnns_slfp_quantization_tpu_torch.utils import native


def _load_pickle(path: pathlib.Path):
    with open(path, "rb") as f:
        return pickle.load(f, encoding="latin1")


def load_cifar(data_dir: str, num_classes: int = 100, train: bool = True):
    """Returns (images uint8 NHWC, labels int32) or raises FileNotFoundError."""
    root = pathlib.Path(data_dir)
    if num_classes == 100:
        path = root / "cifar-100-python" / ("train" if train else "test")
        if not path.exists():
            raise FileNotFoundError(path)
        d = _load_pickle(path)
        data, labels = d["data"], d["fine_labels"]
    else:
        base = root / "cifar-10-batches-py"
        names = ([f"data_batch_{i}" for i in range(1, 6)] if train
                 else ["test_batch"])
        if not (base / names[0]).exists():
            raise FileNotFoundError(base / names[0])
        parts = [_load_pickle(base / n) for n in names]
        data = np.concatenate([p["data"] for p in parts])
        labels = sum((list(p["labels"]) for p in parts), [])
    images = np.asarray(data, np.uint8).reshape(-1, 3, 32, 32).transpose(
        0, 2, 3, 1)
    return images, np.asarray(labels, np.int32)


class CifarIterator:
    """Epoch iterator yielding (normalized NHWC float32, labels int32); the
    augmenter is picked at creation: native when the library builds."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 batch_size: int, *, train: bool, seed: int = 0,
                 drop_remainder: bool = False):
        self.images, self.labels = images, labels
        self.batch_size = batch_size
        self.train = train
        self.rng = np.random.default_rng(seed)
        self.drop_remainder = drop_remainder
        self.use_native = native.available()

    def __len__(self):
        n = len(self.images) // self.batch_size
        if not self.drop_remainder and len(self.images) % self.batch_size:
            n += 1
        return n

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        idx = np.arange(len(self.images))
        if self.train:
            self.rng.shuffle(idx)
        for s in range(0, len(idx), self.batch_size):
            sel = idx[s:s + self.batch_size]
            if self.drop_remainder and len(sel) < self.batch_size:
                break
            imgs = self.images[sel]
            if self.use_native:
                x = native.cifar_augment(
                    imgs, transforms.CIFAR_MEAN, transforms.CIFAR_STD,
                    train=self.train,
                    seed=int(self.rng.integers(0, 2**63)) if self.train else 0)
            elif self.train:
                x = transforms.cifar_train(imgs, self.rng)
            else:
                x = transforms.cifar_eval(imgs)
            yield x, self.labels[sel]


def make_iterators(data_dir: str, num_classes: int, train_batch: int,
                   eval_batch: int, seed: int = 0,
                   drop_remainder: bool = False,
                   train_subset: float = 1.0):
    tr_im, tr_lb = load_cifar(data_dir, num_classes, train=True)
    ev_im, ev_lb = load_cifar(data_dir, num_classes, train=False)
    if train_subset < 1.0:
        from cnns_slfp_quantization_tpu_torch.data import subset

        sel = subset.stratified_indices(tr_lb, train_subset, seed)
        tr_im, tr_lb = tr_im[sel], tr_lb[sel]
    train = CifarIterator(tr_im, tr_lb, train_batch, train=True, seed=seed,
                          drop_remainder=drop_remainder)
    print(f"==> CIFAR-{num_classes} augmenter: " + (
        f"native ({native.path.name})" if train.use_native
        else "numpy (transforms.cifar_train / cifar_eval)"), flush=True)
    return (
        train,
        CifarIterator(ev_im, ev_lb, eval_batch, train=False,
                      drop_remainder=drop_remainder),
    )
