"""The plain references against the port at a test's size on the CPU (the
port's plain kernel versions): the served logits and the QAT steps agree
bit for bit on the benchmark's exact inputs, and the controls do not."""

import pytest
import torch

from benchmark import checks, inputs
from benchmark.conftest import small_cell
from benchmark.reference.common import Numerics

SERVE = ("resnet50-serve-b256", "mobilenetv1-serve-b256")


def _setup(cell, seed, tmp_path):
    p, scales = inputs.model(cell, seed, "cpu")
    inputs.save(p, scales, tmp_path / "w.pt", tmp_path / "s.json")
    return p, scales


@pytest.mark.parametrize("name", SERVE)
def test_served_logits_equal_the_reference(name, tmp_path):
    from cnns_slfp_quantization_tpu_torch.serve import InferenceEngine

    cell = small_cell(name)
    cfg, ref = cell.config, cell.reference
    p, scales = _setup(cell, 12345, tmp_path)
    ka, kw = inputs.scale_arrays(scales)
    x = inputs.images(2, 32, 12345, 3, "cpu")
    policy = cfg["serve"]["policy"]
    if policy:
        policy = {"chain": frozenset(policy["chain"])}
    eng = InferenceEngine(cfg["serve"]["net"], qbit=8, batch_size=2,
                          image_size=32, checkpoint=str(tmp_path / "w.pt"),
                          scales=str(tmp_path / "s.json"), policy=policy,
                          device="cpu")
    with torch.no_grad():
        r = ref.serve_forward(p, x, ka, kw, policy=cfg["serve"]["policy"])
        c = ref.serve_forward(p, x, ka, kw, policy=cfg["serve"]["policy"],
                              num=Numerics(operand=torch.float8_e4m3fn))
    limit = cfg["limits"]["serve"]["logit_gap"]
    assert max(checks.logit_gaps(eng.forward(x).float(), r.float())) < limit
    assert max(checks.logit_gaps(c.float(), r.float())) > limit


def test_qat_steps_equal_the_reference(tmp_path):
    from cnns_slfp_quantization_tpu_torch import calib, models
    from cnns_slfp_quantization_tpu_torch.train import loop, optimizers

    from benchmark.reference import train as ref_train

    # 64x64: at 32x32 the last stage is 1x1, where a tensor's memory
    # format is ambiguous and BatchNorm's reductions may take another order
    cell = small_cell("resnet50-qat-b64")
    cell.config = dict(cell.config, image_size=64)
    cell.traffic = dict(cell.traffic, batch=4)
    cfg, t = cell.config, cell.config["train"]
    p, scales = _setup(cell, 777, tmp_path)
    ka, kw = inputs.scale_arrays(scales)
    batches = [(inputs.images(4, 64, 777, 10 + i, "cpu"),
                inputs.labels(4, 1000, 777, 20 + i, "cpu")) for i in range(3)]
    model = models.create_model(
        "resnet", 8, compute_dtype=torch.bfloat16, image_size=64,
        scales=calib.load_scales_path(tmp_path / "s.json"))
    model.load_state_dict(torch.load(tmp_path / "w.pt", weights_only=True))
    opt = optimizers.dsgd(model.parameters(), t["lr"], 8)
    state, step = loop.TrainState(model, opt), loop.make_train_step(model, opt)
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    losses = []
    for i, (x, y) in enumerate(batches):
        losses.append(float(step(state, x, y)["loss"]))
        if i == 0:
            g1 = {k: opt.state[v]["momentum"].double()
                  - 5e-4 * p0[k].double() for k, v in model.named_parameters()}
    prog = {"loss": losses, "grad1": g1,
            "change": {k: v.detach() - p0[k]
                       for k, v in model.named_parameters()}}
    kws = dict(lr=t["lr"], momentum=t["momentum"],
               weight_decay=t["weight_decay"], tol=t["tol"])
    ref = ref_train.qat_steps(cell.reference, p, batches, ka, kw, **kws)
    got = checks.train_numbers(prog, ref)
    assert got["loss_gap"] == 0 and got["change_gap"] == 0, got
    assert got["grad_gap"] < 1e-6, got
