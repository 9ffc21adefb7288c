"""The port's data pipeline held against the JAX package on the CPU:
``data/subset.py``, ``data/transforms.py``, the native library
(``utils/native.py``, built from ``native/slfp_native.cpp`` into the port's
build directory), CIFAR on disk in torchvision's layout with both
augmenters, ImageNet ImageFolders of JPEGs, and the drivers reading them
(``--pre_reference``, a ``--train_subset`` retrain, a full validation).  Datasets are
written here from a seed: nothing is downloaded.
"""

import ast
import pathlib
import pickle

import numpy as np
import pytest
import torch

from cnns_slfp_quantization_tpu.cli import imgnet_train_eval as jimgnet
from cnns_slfp_quantization_tpu.data import cifar as jcifar
from cnns_slfp_quantization_tpu.data import imagenet as jimagenet
from cnns_slfp_quantization_tpu.data import subset as jsubset
from cnns_slfp_quantization_tpu.data import transforms as jtransforms
from cnns_slfp_quantization_tpu.utils import native as jnative
from cnns_slfp_quantization_tpu_torch.cli import cifar100_train_eval as tcli
from cnns_slfp_quantization_tpu_torch.cli import imgnet_train_eval as timgnet
from cnns_slfp_quantization_tpu_torch.data import cifar as tcifar
from cnns_slfp_quantization_tpu_torch.data import imagenet as timagenet
from cnns_slfp_quantization_tpu_torch.data import subset as tsubset
from cnns_slfp_quantization_tpu_torch.data import transforms as ttransforms
from cnns_slfp_quantization_tpu_torch.utils import native as tnative

# the suite runs in several processes at once: one intra-op thread each
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "cnns_slfp_quantization_tpu_torch"
needs_native = pytest.mark.skipif(
    not (jnative.available() and tnative.available()),
    reason="no C++ compiler for the native library")


# -------------------------------------------------------------- subset
@pytest.mark.parametrize("fraction", [0.01, 0.06, 0.5, 1.0])
def test_stratified_indices_equal_jax(fraction):
    labels = np.random.default_rng(0).integers(0, 100, 5000).astype(np.int32)
    for seed in (0, 3):
        np.testing.assert_array_equal(
            tsubset.stratified_indices(labels, fraction, seed),
            jsubset.stratified_indices(labels, fraction, seed))


def test_stratified_indices_edge_cases():
    labels = np.asarray([0, 0, 0, 1, 1, 2], np.int32)
    sel = tsubset.stratified_indices(labels, 0.01, seed=0)
    np.testing.assert_array_equal(
        sel, jsubset.stratified_indices(labels, 0.01, seed=0))
    assert set(labels[sel]) == {0, 1, 2} and len(sel) == 3  # ceil: 1 each
    np.testing.assert_array_equal(tsubset.stratified_indices(labels, 1.0),
                                  np.arange(6))
    for bad in (0.0, -0.1, 1.5):
        with pytest.raises(ValueError, match="fraction"):
            tsubset.stratified_indices(labels, bad)


# ---------------------------------------------------------- transforms
def test_transforms_equal_jax():
    for name in ("CIFAR_MEAN", "CIFAR_STD", "IMGNET_MEAN", "IMGNET_STD"):
        np.testing.assert_array_equal(getattr(ttransforms, name),
                                      getattr(jtransforms, name))
    imgs = np.random.default_rng(1).integers(0, 256, (6, 32, 32, 3),
                                             dtype=np.uint8)
    np.testing.assert_array_equal(ttransforms.cifar_eval(imgs),
                                  jtransforms.cifar_eval(imgs))
    np.testing.assert_array_equal(
        ttransforms.cifar_train(imgs, np.random.default_rng(2)),
        jtransforms.cifar_train(imgs, np.random.default_rng(2)))
    np.testing.assert_array_equal(ttransforms.imgnet_normalize(imgs),
                                  jtransforms.imgnet_normalize(imgs))


# -------------------------------------------------------------- native
@needs_native
def test_native_library_is_the_ports_own_and_equals_jax():
    """Built from native/slfp_native.cpp into build/native/ (never the
    library ``make -C native`` leaves in native/), with the same results."""
    assert tnative.path.parent == REPO / "build" / "native"
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(70_000) * 4).astype(np.float32)
    np.testing.assert_array_equal(tnative.slfp34_pack(x),
                                  jnative.slfp34_pack(x))
    codes = rng.integers(0, 256, 1000, dtype=np.uint8)
    np.testing.assert_array_equal(tnative.slfp34_unpack(codes),
                                  jnative.slfp34_unpack(codes))
    np.testing.assert_array_equal(tnative.slfp34_quantize_act(x),
                                  jnative.slfp34_quantize_act(x))
    assert tnative.absmax(x) == jnative.absmax(x) == np.abs(x).max()
    imgs = rng.integers(0, 256, (5, 32, 32, 3), dtype=np.uint8)
    for train, seed in ((False, 0), (True, 12345)):
        np.testing.assert_array_equal(
            tnative.cifar_augment(imgs, ttransforms.CIFAR_MEAN,
                                  ttransforms.CIFAR_STD, train=train,
                                  seed=seed),
            jnative.cifar_augment(imgs, jtransforms.CIFAR_MEAN,
                                  jtransforms.CIFAR_STD, train=train,
                                  seed=seed))


# ------------------------------------------------------- CIFAR on disk
def write_cifar(root: pathlib.Path, n_train=200, n_test=50, seed=0,
                classes=100):
    """CIFAR in torchvision's on-disk layout from a seed: the
    ``cifar-100-python/{train,test}`` pickles (``fine_labels``), or
    CIFAR-10's ``cifar-10-batches-py/{data_batch_1..5,test_batch}``."""
    rng = np.random.default_rng(seed)

    def part(n, key):
        return {"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                key: rng.integers(0, classes, n).tolist()}

    if classes == 100:
        d = root / "cifar-100-python"
        files = {"train": part(n_train, "fine_labels"),
                 "test": part(n_test, "fine_labels")}
    else:
        d = root / "cifar-10-batches-py"
        files = {f"data_batch_{i}": part(n_train // 5, "labels")
                 for i in range(1, 6)}
        files["test_batch"] = part(n_test, "labels")
    d.mkdir(parents=True, exist_ok=True)
    for name, obj in files.items():
        with open(d / name, "wb") as f:
            pickle.dump(obj, f)
    return root


@pytest.fixture(scope="module")
def cifar_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("cifar")
    write_cifar(root)
    write_cifar(root, n_train=60, n_test=20, seed=1, classes=10)
    return root


def _batches(it, epochs):
    return [(x, y) for _ in range(epochs) for x, y in it]


@pytest.mark.parametrize("native_on", [
    pytest.param(True, marks=needs_native), False], ids=["native", "numpy"])
@pytest.mark.parametrize("classes,subset", [(100, 1.0), (100, 0.3),
                                            (10, 1.0)])
def test_cifar_iterators_yield_jax_batches(cifar_dir, monkeypatch, capsys,
                                           native_on, classes, subset):
    """Two train epochs (a fresh shuffle and augmentation each) and the
    eval set, bit for bit, on the augmenter JAX would pick."""
    if not native_on:
        monkeypatch.setattr(jnative, "available", lambda: False)
        monkeypatch.setattr(tnative, "available", lambda: False)
    want = jcifar.make_iterators(str(cifar_dir), classes, 32, 16,
                                 train_subset=subset)
    got = tcifar.make_iterators(str(cifar_dir), classes, 32, 16,
                                train_subset=subset)
    assert got[0].use_native == got[1].use_native == native_on
    printed = capsys.readouterr().out
    assert ("native" if native_on else "numpy") in printed
    for g, w, epochs in zip(got, want, (2, 1)):
        assert len(g) == len(w)
        gb, wb = _batches(g, epochs), _batches(w, epochs)
        assert len(gb) == len(wb) == epochs * len(w)
        for (gx, gy), (wx, wy) in zip(gb, wb):
            assert gx.dtype == np.float32 and gx.shape[1:] == (32, 32, 3)
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)


def test_load_cifar_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tcifar.load_cifar(str(tmp_path), 100)
    with pytest.raises(FileNotFoundError):
        tcifar.load_cifar(str(tmp_path), 10, train=False)


# ------------------------------------------------------------ ImageNet
@pytest.fixture(scope="module")
def imagenet_dir(tmp_path_factory):
    """``train`` and ``val`` ImageFolders of 3 classes x 2 JPEGs of
    assorted sizes; returns ``train``."""
    Image = pytest.importorskip("PIL.Image")
    base = tmp_path_factory.mktemp("imagenet")
    rng = np.random.default_rng(4)
    for split in ("train", "val"):
        for c, wnid in enumerate(("n01440764", "n01443537", "n01484850")):
            (base / split / wnid).mkdir(parents=True)
            for i, (w, h) in enumerate(((40, 30), (28, 44))):
                arr = rng.integers(0, 256, (h + 4 * c, w, 3), dtype=np.uint8)
                Image.fromarray(arr).save(base / split / wnid / f"img{i}.JPEG")
    (base / "train" / "n01440764" / "notes.txt").write_text("not an image")
    return base / "train"


@pytest.mark.parametrize("train,subset", [(False, 1.0), (True, 1.0),
                                          (True, 0.5)])
def test_imagenet_iterator_yields_jax_batches(imagenet_dir, train, subset):
    """The same files, labels and batches as JAX's, whatever the number of
    workers (each image draws from its own seed)."""
    want = jimagenet.ImageNetIterator(str(imagenet_dir), 4, train=train,
                                      workers=2, subset_fraction=subset)
    got = timagenet.ImageNetIterator(str(imagenet_dir), 4, train=train,
                                     workers=3, subset_fraction=subset)
    assert got.paths == want.paths and got.classes == want.classes
    np.testing.assert_array_equal(got.labels, want.labels)
    assert len(got) == len(want)
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.shape[1:] == (224, 224, 3) and gx.dtype == np.float32
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


# ----------------------------------------------- the CIFAR driver on disk
def test_cifar_driver_reads_disk(cifar_dir, tmp_path, capsys):
    """``--pre_reference`` writes its three files under --root_dir; then a
    --train_subset 0.06 retrain at bf16 reads the same directory."""
    common = ["--device", "cpu", "--net", "mobilenet", "--data_dir",
              str(cifar_dir), "--eval_batch_size", "50"]
    tcli.main(common + ["--Qbits", "32", "--pre_reference", "--root_dir",
                        str(tmp_path)])
    for name in ("max_inout_mobilenet.txt", "max_weight_mobilenet.txt",
                 "calib/mobilenet_calibrated.json"):
        assert (tmp_path / name).stat().st_size > 0, name
    inout = (tmp_path / "max_inout_mobilenet.txt").read_text()
    assert inout.startswith("Layer 0 Max Absolute Input:\n")
    state, accs = tcli.main(common + [
        "--Qbits", "8", "--compute_dtype", "bfloat16", "--retrain",
        "--train_subset", "0.06", "--train_batch_size", "128",
        "--optimizer", "DSGD", "--root_dir", str(tmp_path / "run")])
    n = len(jsubset.stratified_indices(
        jcifar.load_cifar(str(cifar_dir), 100)[1], 0.06))
    assert state.step == -(-n // 128) == 1 and len(accs) == 1
    out = capsys.readouterr().out
    assert "augmenter" in out and "(50 images)" in out


def test_imagenet_driver_flags_are_jax_flags():
    """JAX's flags and defaults, plus ``--device``; ``--data_dir`` names no
    machine's path (JAX's default is its own host's dataset directory)
    and ``--jax_cache`` is accepted and ignored."""
    def defaults(parser):
        return {a.dest: a.default for a in parser._actions
                if a.dest != "help"}

    want, got = defaults(jimgnet.make_parser()), defaults(
        timgnet.make_parser())
    assert set(got) - set(want) == {"device"} and set(want) <= set(got)
    assert {k for k in want if want[k] != got[k]} == {"data_dir",
                                                      "jax_cache"}
    assert got["device"] == "cuda"


def test_imagenet_driver_reads_image_folders(imagenet_dir, tmp_path,
                                             capsys):
    """``--pre_reference`` over ``val`` writes its three files, and
    ``--all_validate`` evaluates every image of ``val`` (JAX's smoke eval
    caps at 100: imgnet_train_eval.py:182-185)."""
    common = ["--device", "cpu", "--net", "squeezenet", "--data_dir",
              str(imagenet_dir.parent), "--eval_batch_size", "4",
              "--num_workers", "2"]
    timgnet.main(common + ["--pre_reference", "--root_dir", str(tmp_path)])
    for name in ("max_inout_squeezenet.txt", "max_weight_squeezenet.txt",
                 "calib/squeezenet_calibrated.json"):
        assert (tmp_path / name).stat().st_size > 0, name
    _, accs = timgnet.main(common + [
        "--Qbits", "8", "--compute_dtype", "bfloat16", "--all_validate",
        "--max_epochs", "1", "--root_dir", str(tmp_path / "run")])
    assert len(accs) == 1
    assert "(6 images)" in capsys.readouterr().out


# ---------------------------------------------------------------- guard
@pytest.mark.parametrize("path", sorted(
    [*(PORT / "data").glob("*.py"), *(PORT / "cli").glob("*.py"),
     PORT / "utils" / "native.py"]), ids=lambda p: str(p.relative_to(REPO)))
def test_data_and_cli_read_no_file_of_the_jax_package(path):
    """No string of these modules names a path inside the JAX package
    (the import guard is in test_torch_port_resnet.py / _cli.py)."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            s = node.value.replace("cnns_slfp_quantization_tpu_torch", "")
            assert "cnns_slfp_quantization_tpu/" not in s, (path, s)
            assert "cnns_slfp_quantization_tpu\\" not in s, (path, s)
