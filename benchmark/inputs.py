"""Everything a run feeds both sides, made from ``--seed``: images, labels,
float weights by the port's state_dict names, BatchNorm's parameters and
statistics, and the quantization scales.

A quantized network's outputs jump where a value crosses one of its
quantization bins, and every layer's quantizer turns a difference of one
rounding into a jump that the next layers spread: two sound programs
that sum in different orders soon disagree everywhere.  So the inputs are
chosen for the sums to be exact, whatever order a kernel takes them in:

- every quantized layer's raw weight lies off SLFP<3,4>'s grid, and its
  freeze puts it on a power of two: ``Kw = s / 8``, ``s`` the power of two
  nearest He's (LeCun's for the classifier) standard deviation for the
  mix, and ``w / Kw = +-2**c * 2**(v / 16)``, ``c`` 3, 2 or 1, ``|v| <
  1/4``: inside mantissa bin 0, on both sides of it (bins 0 and 16 of
  the table), so the freeze gives ``+-2**c``; sign, ``c`` and ``v`` drawn
  at random.  A freeze that is skipped, or rounds by a wrong table, leaves
  operands that are no powers of two, and sums that are not exact.  (The
  weights' subnormal and pseudo-zero branches stay unused: a weight
  operand of 1/8 or 1e-10 would put the products on a grid too fine for
  float32 to sum exactly);
- every scale is a power of two: ``Ka`` the least one with ``max|x| / Ka
  <= 15.32`` over a calibration forward (unquantized, float32) of
  ``calibration_images`` images drawn from the seed;
- BatchNorm's inference form is exact: its running variance is the
  float32 value whose ``var + eps`` is ``4**j``, ``2**j`` the power of two
  nearest the std of its input in that forward, ``gamma`` is 1 (1/2 for
  about a third of the channels), so ``gamma / sqrt(var + eps)`` is a power
  of two; its running mean is that input's mean on a dyadic grid of
  ``2**(j - 3)``, and its shift a multiple of 1/8 within +-1/4.  In
  training, BatchNorm normalizes by the batch and scales by ``gamma``.

A quantized activation is a bf16 value of at most 8 significant bits
between 2^-3 and 16, so each product is a multiple of 2^-9 below 2^7 and
the sums of a layer stay well inside float32's 24 bits.  What is left
inexact (BatchNorm's batch statistics in training, the mean pool, a
float32 classifier) is computed by the same operations on both sides or
sits in the head, where a different rounding moves the logits by about a
bf16 ulp and nothing after it amplifies that.  The images are standard
normal, as normalized ImageNet inputs are distributed.
"""

from __future__ import annotations

import json
import math

import numpy as np
import torch

from benchmark.reference import common

DIVISOR = 15.5        # the port's scale JSON: k = k_max / divisor
SLFP_MAX = 15.32165


def sub_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed for one stream of a run's seed (any whole number)."""
    words = np.random.SeedSequence([int(seed) & (2**64 - 1), *keys])
    return int(words.generate_state(2, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, key: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, key))


def images(n: int, size: int, seed: int, key: int, device) -> torch.Tensor:
    """n NHWC float32 images, standard normal."""
    return torch.randn(n, size, size, 3, device=device,
                       generator=generator(seed, key, device))


def labels(n: int, classes: int, seed: int, key: int, device) -> torch.Tensor:
    return torch.randint(0, classes, (n,), device=device,
                         generator=generator(seed, key, device))


def _pow2(v: float) -> float:
    return 2.0 ** round(math.log2(v))


def weights(shapes: dict, quantized: set, seed: int, device) -> dict:
    """name -> tensor for every entry of ``shapes``, from one ``randn``
    call; ``quantized`` names the weights of quantized layers.  BatchNorm's
    entries hold raw normal draws until :func:`calibrate` sets them."""
    drawn = [k for k in shapes
             if not k.endswith(("running_mean", "running_var",
                                "num_batches_tracked"))]
    total = sum(math.prod(shapes[k]) for k in drawn)
    flat = torch.randn(total, generator=generator(seed, 1, device),
                       device=device)
    offs = torch.rand(total, generator=generator(seed, 7, device),
                      device=device)
    out, at = {}, 0
    for k, shape in shapes.items():
        if k.endswith("num_batches_tracked"):
            out[k] = torch.zeros(shape, dtype=torch.int64, device=device)
            continue
        if k.endswith(("running_mean", "running_var")):
            out[k] = torch.zeros(shape, device=device)
            continue
        n = math.prod(shape)
        u = flat[at:at + n].view(shape)
        r = offs[at:at + n].view(shape)
        at += n
        fan_in = math.prod(shape[1:])
        if k in quantized:
            # 50% of size s, 35% s/2, 15% s/4, each times 2**(v/16):
            # E[w^2] ~ 0.6 s^2 against He's 2 / fan_in (a classifier's
            # LeCun 1 / fan_in)
            var = (2.0 if len(shape) == 4 else 1.0) / fan_in
            s = _pow2(math.sqrt(var / 0.6))
            a = u.abs()
            size = torch.where(a > 0.6745, s,
                               torch.where(a > 0.1891, s / 2, s / 4))
            off = torch.exp2((r - 0.5) * (0.5 / 16))      # 2**(v/16)
            out[k] = size * off * torch.sign(u)
        elif len(shape) == 2:                      # float classifier
            out[k] = u * math.sqrt(1.0 / fan_in)
        elif k.startswith("fc."):                  # classifier bias
            out[k] = u * 0.01
        else:                                      # BatchNorm draws
            out[k] = u.clone()
    return out


def _var_for(j: int) -> float:
    """The float32 ``v`` nearest ``4**j - 1e-5`` with ``v + 1e-5 == 4**j``
    in float32, so that BatchNorm's ``sqrt(var + eps)`` is ``2**j``."""
    eps, target = np.float32(1e-5), np.float32(4.0 ** j)
    v = np.float32(4.0 ** j - 1e-5)
    for _ in range(64):
        s = np.float32(v + eps)
        if s == target:
            return float(v)
        v = np.nextafter(v, np.float32(np.inf if s < target else -np.inf),
                         dtype=np.float32)
    raise ValueError(f"no float32 variance gives sqrt(var + eps) = 2**{j}")


def _set_bn(p: dict, name: str, x: torch.Tensor) -> None:
    """BatchNorm near its input's statistics, with an exact inference form:
    ``sqrt(var + eps) = 2**j`` (``2**j`` the power of two nearest the
    input's std), ``gamma`` 1 or 1/2, so that ``gamma / sqrt(var + eps)``
    is a power of two; the mean on a grid of ``2**(j - 3)``, the shift a
    multiple of 1/8."""
    x = x.to(torch.float32)
    mean = x.mean(dim=(0, 2, 3))
    std = (x.square().mean(dim=(0, 2, 3)) - mean.square()).clamp(
        min=1e-12).sqrt()
    j = torch.round(torch.log2(std))
    var = {int(k): _var_for(int(k)) for k in j.unique().tolist()}
    u_g, u_b = p[f"{name}.weight"], p[f"{name}.bias"]
    p[f"{name}.weight"] = torch.where(u_g < -0.43, 0.5, 1.0).to(mean)
    p[f"{name}.running_var"] = torch.tensor(
        [var[int(k)] for k in j.tolist()], dtype=torch.float32,
        device=mean.device)
    grid = torch.exp2(j - 3)
    p[f"{name}.running_mean"] = torch.round(mean / grid) * grid
    p[f"{name}.bias"] = torch.clamp(torch.round(u_b), -2, 2) * 0.125


def calibrate(reference, p: dict, x: torch.Tensor, n_scales: int) -> dict:
    """Set ``p``'s BatchNorm entries by a calibration forward of
    ``reference`` on ``x`` and return the scale set as the port's JSON
    holds it (``divisor``, ``ka_max``, ``kw_max``): powers of two times
    the divisor."""
    cal = common.Calibrator(lambda name, v: _set_bn(p, name, v))
    with common.tf32(False):        # the same seed, the same inputs
        reference.calibrate(p, x, cal)
    if sorted(cal.in_max) != list(range(n_scales)):
        raise ValueError(f"calibration saw scale indices "
                         f"{sorted(cal.in_max)}, expected 0..{n_scales - 1}")

    def scale(m):
        return 2.0 ** math.ceil(math.log2(max(m, 1e-30) / SLFP_MAX))

    ka = [scale(cal.in_max[i]) for i in range(n_scales)]
    kw = [1.0] * n_scales
    for name, sid in reference.weight_ids().items():
        kw[sid] = scale(float(p[name].abs().max()))
    return {"source": "benchmark calibration", "divisor": DIVISOR,
            "ka_max": [k * DIVISOR for k in ka],
            "kw_max": [k * DIVISOR for k in kw]}


def model(cell, seed: int, dev):
    """(weights by name, scale JSON) of a cell's configuration, from the
    seed: :func:`weights`, then :func:`calibrate` on the configuration's
    ``calibration_images``."""
    cfg, ref = cell.config, cell.reference
    p = weights(ref.param_shapes(cfg["num_classes"]), set(ref.weight_ids()),
                seed, dev)
    x = images(cfg["calibration_images"], cfg["image_size"], seed, 2, dev)
    return p, calibrate(ref, p, x, ref.N_SCALES)


def scale_arrays(scales: dict):
    """(ka, kw) as the port's loader makes them: float64 max / divisor."""
    div = float(scales["divisor"])
    return (np.asarray(scales["ka_max"], np.float64) / div,
            np.asarray(scales["kw_max"], np.float64) / div)


def save(p: dict, scales: dict, ckpt_path, scales_path) -> None:
    """The checkpoint (a state_dict saved with ``torch.save``, on the CPU)
    and the scale JSON that the program loads."""
    torch.save({k: v.detach().cpu() for k, v in p.items()}, ckpt_path)
    with open(scales_path, "w") as f:
        json.dump(scales, f)


def load(ckpt_path, device) -> dict:
    sd = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    return {k: v.to(device) for k, v in sd.items()}
