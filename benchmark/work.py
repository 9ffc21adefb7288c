"""The work of a forward, counted from a configuration's layer table (the
model's published layer shapes), never from the program's tensors: a
kernel that fuses or skips a write does not lower the yardstick.

A layer's multiply-adds are ``out_hw**2 * cout * (cin / groups) * k**2``
(a pool has none); its FLOPs are twice that.  Its bytes are its input read
once, its weights read once and its output written once, at the sizes the
configuration states (``bytes``: ``activation``, ``weight``; a layer may
state its own ``in_bytes``, ``weight_bytes``, ``out_bytes``).
"""

from __future__ import annotations

from benchmark import peaks


def macs(layer: dict) -> int:
    """Multiply-adds of one image through ``layer``."""
    if layer["kind"] == "pool":
        return 0
    return (layer["out_hw"] ** 2 * layer["cout"]
            * (layer["cin"] // layer["groups"]) * layer["k"] ** 2)


def flops_per_image(config: dict) -> float:
    """2 x the multiply-adds of one image's forward."""
    return 2.0 * sum(macs(lay) for lay in config["layers"])


def layer_bytes(layer: dict, sizes: dict, batch: int) -> float:
    """Bytes ``batch`` images move through ``layer``: input and output per
    image, the weights once."""
    a = sizes["activation"]
    ins = layer["in_hw"] ** 2 * layer["cin"] * layer.get("in_bytes", a)
    outs = layer["out_hw"] ** 2 * layer["cout"] * layer.get("out_bytes", a)
    weights = 0
    if layer["kind"] != "pool":
        weights = (layer["cout"] * (layer["cin"] // layer["groups"])
                   * layer["k"] ** 2
                   * layer.get("weight_bytes", sizes["weight"]))
    return batch * (ins + outs) + weights


def least_seconds(config: dict, batch: int, peak_flops: float) -> float:
    """The least time of one forward of ``batch`` images: the sum over the
    layers of max(FLOPs / peak, bytes / HBM bandwidth)."""
    return sum(
        peaks.bound_ms(layer_bytes(lay, config["bytes"], batch),
                       2.0 * macs(lay) * batch, peak_flops)[0] / 1e3
        for lay in config["layers"])
