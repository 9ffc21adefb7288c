"""Input preprocessing (a copy of the JAX package's ``data/transforms.py``,
numpy only), bit-matching the reference's torchvision pipelines
(utils/preprocessing.py).

Normalization constants (preprocessing.py:10, :27-28, :33-34):
  CIFAR:    mean (0.4914, 0.4822, 0.4465), std (0.2023, 0.1994, 0.2010)
  ImageNet: mean (0.485, 0.456, 0.406),   std (0.229, 0.224, 0.225)

All transforms are NHWC numpy (host-side); augmentation randomness comes
from a caller-provided ``np.random.Generator``.
"""

from __future__ import annotations

import numpy as np

CIFAR_MEAN = np.asarray([0.4914, 0.4822, 0.4465], np.float32)
CIFAR_STD = np.asarray([0.2023, 0.1994, 0.2010], np.float32)
IMGNET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMGNET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def normalize(x: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    """x in [0,1] NHWC float32 -> standardized."""
    return (x - mean) / std


def cifar_eval(images_u8: np.ndarray) -> np.ndarray:
    """ToTensor + Normalize (preprocessing.py:12-13)."""
    x = images_u8.astype(np.float32) / 255.0
    return normalize(x, CIFAR_MEAN, CIFAR_STD).astype(np.float32)


def cifar_train(images_u8: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """RandomHorizontalFlip + reflect-Pad(4) + RandomCrop(32)
    (preprocessing.py:6-9), then normalize."""
    n, h, w, _ = images_u8.shape
    out = np.empty_like(images_u8)
    flip = rng.random(n) < 0.5
    padded = np.pad(images_u8, ((0, 0), (4, 4), (4, 4), (0, 0)), mode="reflect")
    ys = rng.integers(0, 9, n)
    xs = rng.integers(0, 9, n)
    for i in range(n):
        img = padded[i, ys[i]:ys[i] + h, xs[i]:xs[i] + w]
        out[i] = img[:, ::-1] if flip[i] else img
    return cifar_eval(out)


def imgnet_eval_pil(img) -> np.ndarray:
    """Resize(256 shorter side) + CenterCrop(224) on a PIL image
    (preprocessing.py:30-31); returns HWC uint8."""
    from PIL import Image

    w, h = img.size
    if w <= h:
        nw, nh = 256, max(1, round(h * 256 / w))
    else:
        nh, nw = 256, max(1, round(w * 256 / h))
    img = img.resize((nw, nh), Image.BILINEAR)
    left, top = (nw - 224) // 2, (nh - 224) // 2
    img = img.crop((left, top, left + 224, top + 224))
    return np.asarray(img.convert("RGB"), np.uint8)


def imgnet_train_pil(img, rng: np.random.Generator) -> np.ndarray:
    """RandomResizedCrop(224) + HFlip + ColorJitter(0.5,0.5,0.3)
    (preprocessing.py:21-25); returns HWC uint8."""
    from PIL import Image

    w, h = img.size
    area = w * h
    for _ in range(10):
        target = area * rng.uniform(0.08, 1.0)
        ar = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
        cw = int(round(np.sqrt(target * ar)))
        ch = int(round(np.sqrt(target / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            left = int(rng.integers(0, w - cw + 1))
            top = int(rng.integers(0, h - ch + 1))
            img = img.crop((left, top, left + cw, top + ch))
            break
    else:  # fallback: center crop
        s = min(w, h)
        left, top = (w - s) // 2, (h - s) // 2
        img = img.crop((left, top, left + s, top + s))
    img = img.resize((224, 224), Image.BILINEAR)
    if rng.random() < 0.5:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    arr = np.asarray(img.convert("RGB"), np.float32)
    # ColorJitter(brightness=0.5, contrast=0.5, saturation=0.3)
    b = rng.uniform(0.5, 1.5)
    c = rng.uniform(0.5, 1.5)
    s = rng.uniform(0.7, 1.3)
    arr = arr * b
    gray = arr.mean(axis=-1, keepdims=True)
    arr = gray + (arr - gray) * s
    arr = arr.mean() + (arr - arr.mean()) * c
    return np.clip(arr, 0, 255).astype(np.uint8)


def imgnet_normalize(images_u8: np.ndarray) -> np.ndarray:
    x = images_u8.astype(np.float32) / 255.0
    return normalize(x, IMGNET_MEAN, IMGNET_STD).astype(np.float32)
