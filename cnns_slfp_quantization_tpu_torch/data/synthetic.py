"""Synthetic data for smoke runs / benches (no dataset on disk): a copy of
the JAX package's ``data/synthetic.py`` (numpy only), so that the same
seed gives the same batches in both.

Deterministic class-conditional Gaussian images: class c has a fixed mean
pattern, so models can actually *learn* on synthetic data (loss decreases),
which makes end-to-end training verifiable without CIFAR/ImageNet.
"""

from __future__ import annotations

import numpy as np


class SyntheticIterator:
    """``signal`` scales the class-signature amplitude against unit noise —
    the task-difficulty knob.  The default 0.7 is trivially separable (models
    saturate near 100%); the PTQ-accuracy harness lowers it per net so fp32
    top-1 lands in the informative 60-90% band where quantization-induced
    prediction flips are frequent enough to compare statistically.

    ``proto_res`` sets the class-signature resolution: at the default 4, a
    32px image carries 64 perfectly-correlated copies of each signature
    pixel, so convnets can average the noise away and only very small
    ``signal`` values avoid saturation; a finer grid (e.g. 16) removes that
    redundancy and makes difficulty track ``signal`` smoothly.
    """

    def __init__(self, *, image_size: int = 32, num_classes: int = 100,
                 batch_size: int = 64, num_batches: int = 10, seed: int = 0,
                 channels: int = 3, signal: float = 0.7, proto_res: int = 4,
                 signal_jitter: bool = False):
        self.image_size = image_size
        self.num_classes = num_classes
        self.batch_size = batch_size
        self.num_batches = num_batches
        self.seed = seed
        self.channels = channels
        self.signal = float(signal)
        self.proto_res = proto_res
        # per-image amplitude ~ U[0, 2*signal]: spreads decision margins
        # smoothly so population accuracy tracks `signal` without a cliff,
        # and quantization-induced flips land on genuinely marginal images
        self.signal_jitter = signal_jitter
        g = np.random.default_rng(1234)
        # fixed low-res class signatures, upsampled
        self._proto = g.normal(
            0, 1, (num_classes, proto_res, proto_res, channels)
        ).astype(np.float32)

    def __len__(self):
        return self.num_batches

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        s = self.image_size
        r = self.proto_res
        for _ in range(self.num_batches):
            labels = rng.integers(0, self.num_classes, self.batch_size)
            proto = self._proto[labels]
            proto = np.repeat(np.repeat(proto, s // r, axis=1), s // r, axis=2)
            noise = rng.normal(0, 1, proto.shape).astype(np.float32)
            amp = (self.signal * rng.uniform(0, 2, (self.batch_size, 1, 1, 1))
                   if self.signal_jitter else self.signal)
            yield ((amp * proto + noise).astype(np.float32),
                   labels.astype(np.int32))
