"""ImageNet-1k ImageFolder loading with a threaded host pipeline
(counterpart of the JAX ``data/imagenet.py``).

Walks the torchvision ImageFolder layout (``<root>/<wnid>/*.JPEG``, with
``root`` a dataset's ``train`` or ``val`` directory;
imgnet_train_eval.py:71-86), decodes and augments each image on a host
worker thread with PIL (imported when an image is read), and yields NHWC
float32 batches.  Each image's augmentation draws from its own seed, taken
from the iterator's generator in batch order, so the batches do not depend
on the number of workers and equal JAX's for the same seed.
"""

from __future__ import annotations

import concurrent.futures as cf
import pathlib
from typing import Iterator, Optional

import numpy as np

from cnns_slfp_quantization_tpu_torch.data import transforms

_EXTS = {".jpeg", ".jpg", ".png", ".bmp"}


def index_image_folder(root: str):
    """Returns (paths list, labels int32, class_names) sorted by class name
    (torchvision ImageFolder convention)."""
    rootp = pathlib.Path(root)
    classes = sorted(p.name for p in rootp.iterdir() if p.is_dir())
    paths, labels = [], []
    for i, c in enumerate(classes):
        for f in sorted((rootp / c).rglob("*")):
            if f.suffix.lower() in _EXTS:
                paths.append(str(f))
                labels.append(i)
    return paths, np.asarray(labels, np.int32), classes


class ImageNetIterator:
    def __init__(self, root: str, batch_size: int, *, train: bool,
                 seed: int = 0, workers: int = 4,
                 max_images: Optional[int] = None,
                 subset_fraction: float = 1.0):
        self.paths, self.labels, self.classes = index_image_folder(root)
        if subset_fraction < 1.0:
            from cnns_slfp_quantization_tpu_torch.data import subset

            sel = subset.stratified_indices(self.labels, subset_fraction,
                                            seed)
            self.paths = [self.paths[i] for i in sel]
            self.labels = self.labels[sel]
        if max_images is not None:
            self.paths = self.paths[:max_images]
            self.labels = self.labels[:max_images]
        self.batch_size = batch_size
        self.train = train
        self.rng = np.random.default_rng(seed)
        self.workers = workers

    def __len__(self):
        return (len(self.paths) + self.batch_size - 1) // self.batch_size

    def _load_one(self, path: str, seed: int) -> np.ndarray:
        from PIL import Image

        with Image.open(path) as img:
            if self.train:
                return transforms.imgnet_train_pil(
                    img, np.random.default_rng(seed))
            return transforms.imgnet_eval_pil(img)

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        idx = np.arange(len(self.paths))
        if self.train:
            self.rng.shuffle(idx)
        with cf.ThreadPoolExecutor(self.workers) as pool:
            for s in range(0, len(idx), self.batch_size):
                sel = idx[s:s + self.batch_size]
                seeds = self.rng.integers(0, 2**31, len(sel))
                imgs = list(pool.map(
                    self._load_one, (self.paths[i] for i in sel), seeds))
                x = transforms.imgnet_normalize(np.stack(imgs))
                yield x, self.labels[sel]
