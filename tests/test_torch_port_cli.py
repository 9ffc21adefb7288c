"""The port's CIFAR driver (``cli/cifar100_train_eval.py``) on the CPU:
SLFP8 DSGD training on synthetic data writes JAX's metric names and the
checkpoints, a best checkpoint reloads to the same Precision@1, ``--resume``
continues bit-identically to an uninterrupted run (JAX
tests/test_resume.py:53), the mesh flags (not ported yet) raise, and so
does a dataset directory that holds no CIFAR.  Also the import guard over
the port's new packages.
"""

import ast
import json
import pathlib
import re

import pytest
import torch

from cnns_slfp_quantization_tpu_torch.cli import cifar100_train_eval as cli

# the suite runs in several processes at once: one intra-op thread each
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "cnns_slfp_quantization_tpu_torch"
COMMON = ["--device", "cpu", "--Qbits", "8", "--net", "mobilenet",
          "--optimizer", "DSGD", "--lr", "0.01", "--synthetic", "--retrain",
          "--synthetic_batches", "2", "--train_batch_size", "8",
          "--eval_batch_size", "8"]


def _jax_metric_names():
    """The names JAX's run_main_loop logs, read from its source."""
    src = (REPO / "cnns_slfp_quantization_tpu/cli/common.py").read_text()
    return set(re.findall(r'logger\.scalar\("([^"]+)"', src))


def _ckpt(root):
    return pathlib.Path(root) / "ckpt" / "cifar-100" / "mobilenet0_tmp"


def test_cli_trains_saves_and_reloads(tmp_path, capsys):
    state, accs = cli.main([*COMMON, "--save_model", "--save_state",
                            "--root_dir", str(tmp_path)])
    assert state.step == 2 and len(accs) == 1
    recs = [json.loads(line) for line in (
        tmp_path / "logs" / "cifar-100" / "run.jsonl").read_text().splitlines()]
    assert {r["name"] for r in recs} == _jax_metric_names()
    ckpt = _ckpt(tmp_path)
    assert ckpt.exists() and pathlib.Path(f"{ckpt}_state").exists()
    meta = json.loads(pathlib.Path(f"{ckpt}_state.meta.json").read_text())
    assert meta == {"steps_per_epoch": 2, "acc_max": accs[0], "epoch": 0}
    printed = re.findall(r"Precision@1: ([0-9.]+)%", capsys.readouterr().out)
    # the best checkpoint, evaluated without training, prints the same
    _, again = cli.main(["--device", "cpu", "--Qbits", "8", "--net",
                         "mobilenet", "--synthetic", "--eval_batch_size", "8",
                         "--pretrain", "--pretrain_dir", str(ckpt),
                         "--root_dir", str(tmp_path / "eval")])
    assert again == accs
    assert re.findall(r"Precision@1: ([0-9.]+)%",
                      capsys.readouterr().out) == printed


def test_cli_resume_continues_bit_identically(tmp_path):
    """An uninterrupted 2-epoch run against 1 epoch, then --resume from
    its ``_state`` to 2: the same weights, BN statistics, optimizer state
    and step, bit for bit."""
    a, b = tmp_path / "a", tmp_path / "b"
    cli.main([*COMMON, "--save_state", "--max_epochs", "2",
              "--root_dir", str(a)])
    cli.main([*COMMON, "--save_state", "--max_epochs", "1",
              "--root_dir", str(b)])
    state_b = f"{_ckpt(b)}_state"
    cli.main([*COMMON, "--save_state", "--max_epochs", "2",
              "--resume", state_b, "--root_dir", str(b)])
    want = torch.load(f"{_ckpt(a)}_state", weights_only=True)
    got = torch.load(state_b, weights_only=True)
    assert got["step"] == want["step"] == 4
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    assert got["optimizer"]["count"] == want["optimizer"]["count"] == 4
    for k, st in want["optimizer"]["state"].items():
        assert torch.equal(got["optimizer"]["state"][k]["momentum"],
                           st["momentum"]), k


@pytest.mark.parametrize("flags, match", [
    (["--mesh_data", "2"], "Queue 1 item 9"),
    (["--mesh_model", "2"], "Queue 1 item 9"),
])
def test_cli_unported_flags_raise(tmp_path, flags, match):
    with pytest.raises(NotImplementedError, match=match):
        cli.main([*COMMON, *flags, "--root_dir", str(tmp_path)])


def test_cli_dataset_on_disk_raises(tmp_path):
    """Without --synthetic the driver reads CIFAR from --data_dir
    (``data/cifar.py``); a directory without it raises, naming the file."""
    args = [a for a in COMMON if a != "--synthetic"]
    with pytest.raises(FileNotFoundError, match="cifar-100-python"):
        cli.main([*args, "--root_dir", str(tmp_path), "--data_dir",
                  str(tmp_path / "no_data")])


def test_cli_defaults_to_cuda_and_raises_without_it(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in COMMON if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([*args, "--root_dir", str(tmp_path)])


NEW_PACKAGES = ("train", "utils", "data", "cli")


@pytest.mark.parametrize("path", sorted(
    p for d in NEW_PACKAGES for p in (PORT / d).rglob("*.py")),
    ids=lambda p: str(p.relative_to(REPO)))
def test_training_modules_import_neither_jax_nor_the_jax_package(path):
    """The import guard (tests/test_torch_port_resnet.py walks every port
    module) over the training, data and CLI packages."""
    for node in ast.walk(ast.parse(path.read_text())):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module] if isinstance(node, ast.ImportFrom)
                 and node.module else [])
        for mod in names:
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax"), (path, mod)
            assert top != "cnns_slfp_quantization_tpu", (path, mod)


def test_cli_pretrain_reads_a_reference_pth(tmp_path):
    """``--pretrain_dir x.pth`` imports a reference-layout state_dict by
    position (``load_pth``) into the CIFAR driver's model."""
    from cnns_slfp_quantization_tpu_torch import models
    from cnns_slfp_quantization_tpu_torch.cli import common

    src = models.create_model("mobilenet", 8,
                              generator=torch.Generator().manual_seed(3))
    mods = dict(src.named_modules())
    sd = {}
    for name in src.flax_order():   # the reference's registration order
        for leaf, t in mods[name].state_dict().items():
            sd[f"{name}.{leaf}"] = t
    pth = tmp_path / "mobilenet.pth"
    torch.save(sd, pth)
    cfg = cli.make_parser().parse_args(
        ["--device", "cpu", "--Qbits", "8", "--pretrain", "--pretrain_dir",
         str(pth)])
    model = common.load_pretrained(cfg, common.build_model(
        cfg, "mobilenet", torch.device("cpu")))
    for k, v in src.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(model.state_dict()[k], v), k
