"""The controls through the harness's own verdict: the serving control
(float8 operands) and the training faults planted in the reference come
out not correct, the reference run twice correct.  (The float64-sum
variant is a witness that is read, not judged.)  On the CPU at a test's
size; the ``card`` test runs every variant, TF32 among them (the card's
tensor cores: on the CPU it is the sound reference), at the cells' own
sizes.  At more seeds ``python3 -m benchmark.control`` runs them on a
card."""

import pytest
import torch

from benchmark import control, manifest
from benchmark.conftest import ROOT, small_cell

SOUND, WITNESS = "sound_again", "exact_sums"


def _qat_small():
    cell = small_cell("resnet50-qat-b64")
    cell.config = dict(cell.config, image_size=64)
    cell.traffic = dict(cell.traffic, batch=4)
    return cell


@pytest.mark.parametrize("name", ("resnet50-serve-b256",
                                  "mobilenetv1-serve-b256"))
def test_serving_control_fails(name):
    got = control.serve_control(small_cell(name), 99, torch.device("cpu"))
    assert got["fp8"]["correct"] is False, got


def test_training_faults_fail_and_sound_variants_pass():
    got = control.train_control(_qat_small(), 98, torch.device("cpu"))
    for fault in ("half_batch", "label"):
        assert got[fault]["correct"] is False, got[fault]
    assert got[SOUND]["correct"] is True, got[SOUND]
    assert all(c["value"] == 0 for c in got[SOUND]["checks"].values())


@pytest.mark.card
@pytest.mark.parametrize("name", ("resnet50-serve-b256",
                                  "mobilenetv1-serve-b256",
                                  "resnet50-qat-b64"))
def test_controls_at_the_cells_sizes(name, card):
    cell = manifest.cell(ROOT, name)
    cell.reference = manifest.reference(ROOT, cell.config["reference"])
    run = (control.serve_control if cell.traffic["kind"] == "serve"
           else control.train_control)
    got = run(cell, 2**31 + 97, card)
    for variant, v in got.items():
        if variant != WITNESS:
            assert v["correct"] is (variant == SOUND), (variant, v)
