"""A run's verdict with its timed path broken underneath: the harness
driven on the CPU at a test's size (its look for a card skipped), once
sound and once per fault the cell can have.  Each fault must come out as
not correct."""

import pytest
import torch

from benchmark import run
from benchmark.conftest import small_cell

CPU = torch.device("cpu")


def _serve_fault(kind):
    from cnns_slfp_quantization_tpu_torch.serve import InferenceEngine

    real = InferenceEngine.forward
    last = {}

    def forward(self, x):
        y = real(self, x)
        if kind == "stale":                # a request answered as the last
            y, last["y"] = last.get("y", y), y
        elif kind == "half_batch":         # half the rows never computed
            y = y.clone()
            y[y.shape[0] // 2:] = y[:y.shape[0] - y.shape[0] // 2]
        elif kind == "altered":            # one answer altered
            y = y.clone()
            y[0, 0] += 0.5 * y[0].abs().max()
        return y
    return forward


def _unquantized(monkeypatch):
    """The weights' SLFP<3,4> quantize skipped: the freeze stores ``w /
    Kw`` and the QAT forward convolves with it as it is."""
    from cnns_slfp_quantization_tpu_torch.ops import layers

    def weight_frozen(self):
        w = self.weight
        return w if self.frozen_weights else w * self.rkw32
    monkeypatch.setattr(layers._QuantBase, "weight_frozen", weight_frozen)


@pytest.mark.parametrize("name", ("resnet50-serve-b256",
                                  "mobilenetv1-serve-b256"))
@pytest.mark.parametrize("fault", (None, "stale", "half_batch", "altered",
                                   "unquantized"))
def test_serving_faults_are_not_correct(name, fault, monkeypatch):
    from cnns_slfp_quantization_tpu_torch.serve import InferenceEngine

    if fault == "unquantized":
        _unquantized(monkeypatch)
    elif fault:
        monkeypatch.setattr(InferenceEngine, "forward", _serve_fault(fault))
    cell = small_cell(name)
    if fault == "stale":      # the window's first answer is then not its own
        cell.traffic = dict(cell.traffic, warmup_requests=2)
    res = run.execute(cell, 2**31 + 11, 0.5, False, CPU)
    assert res["correct"] is (fault is None), res["checks"]
    assert list(res)[-1] == "checks"


def _train_fault(kind, make):
    def make_step(model, opt, has_dropout=False):
        step = make(model, opt, has_dropout)

        def broken(state, images, labels, generator=None):
            if kind == "unchanged":        # the state handed back as it was
                saved = {k: v.detach().clone()
                         for k, v in model.state_dict().items()}
                out = step(state, images, labels, generator)
                model.load_state_dict(saved)
                return out
            if kind == "bn_unmoved":       # BatchNorm's leaves not updated
                saved = {k: v.detach().clone()
                         for k, v in model.named_parameters() if v.dim() == 1}
                out = step(state, images, labels, generator)
                with torch.no_grad():
                    for k, v in model.named_parameters():
                        if k in saved:
                            v.copy_(saved[k])
                return out
            if kind == "half_batch":
                n = images.shape[0] // 2
                return step(state, images[:n], labels[:n], generator)
            labels = labels.clone()        # one answer altered
            labels[0] = (labels[0] + 1) % 1000
            return step(state, images, labels, generator)
        return broken
    return make_step


@pytest.mark.parametrize("fault", (None, "unchanged", "half_batch",
                                   "label", "unquantized", "bn_unmoved"))
def test_training_faults_are_not_correct(fault, monkeypatch):
    from cnns_slfp_quantization_tpu_torch.train import loop

    if fault == "unquantized":
        _unquantized(monkeypatch)
    elif fault:
        monkeypatch.setattr(loop, "make_train_step",
                            _train_fault(fault, loop.make_train_step))
    cell = small_cell("resnet50-qat-b64")
    cell.config = dict(cell.config, image_size=64)
    cell.traffic = dict(cell.traffic, batch=4)
    res = run.execute(cell, 2**31 + 13, 0.5, False, CPU)
    assert res["correct"] is (fault is None), res["checks"]
