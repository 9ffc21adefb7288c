"""The port's measuring tools (``utils/bench_roofline.py``,
``bench_train_sites.py``, ``bench_packed.py``, ``bench_packed_fused.py``,
``bench_blockin.py``, ``bench_shufflenet_fused.py``,
``calibrate_act_variants.py``, ``tune_task_signal.py``) held against the
JAX tools they port, on the CPU.

What is compared, each with its bar:

- the roofline's rows under JAX's placement: names, shapes and counts
  equal to ``tools/bench_roofline.py``'s literals (read from its source,
  which is not imported), each product's operations 2*M*N*K of those
  shapes, and the bytes of two rows counted by hand from the port's dtypes
  (exact);
- ``DSGDNoQ`` against JAX's ``_dsgd_noq`` and ``make_optimizer`` against
  the optax chain it stands for, bit for bit over a few steps;
- each tool's ``main`` on the plain versions at 2x32x32 (one timed step:
  its numbers are the host's, never a device's), printing JAX's keys; the
  calibration's JSON against the shipped file's keys and JAX's ``source``
  text; the packed executor's logits bit-equal to the float one's and its
  weights fewer bytes; ``pallas_dual`` bit-identical to ``consumer``
  (JAX's guard, exact); the ShuffleNetV2 gate at JAX's bar (cosine >
  0.98, the same top-1 on decisive rows);
- the profiling helpers' record filtering (lead-in and marker) and the
  lead-in's limit;
- every ported tool's refusal to run without a card unless ``--device
  cpu``, and its imports (no JAX, no JAX package, no ``tools``).

The tools that serve ResNet-50 build their engines through one function
each; here those return one pair of engines (float-frozen and packed,
batch 2, 32x32, seed 0), built once for the module, as a ResNet-50 engine
takes seconds to build on one CPU thread.  ``tools/bench_packed.py`` and
``tools/bench_blockin.py`` are not imported: at import they change JAX's
compilation-cache settings for the whole process.
"""

import ast
import collections
import contextlib
import importlib
import importlib.util
import io
import json
import pathlib
import types

import numpy as np
import optax
import pytest
import torch

from cnns_slfp_quantization_tpu_torch.utils import (
    bench_blockin,
    bench_packed,
    bench_packed_fused,
    bench_roofline,
    bench_shufflenet_fused,
    bench_train_sites,
    calibrate_act_variants,
    profiling,
    tune_task_signal,
)
from test_torch_port_train import _jax_traj, _port_traj

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
TOOLS = REPO / "tools"
PORT = REPO / "cnns_slfp_quantization_tpu_torch"
PORTED = ("bench_roofline", "bench_train_sites", "bench_packed",
          "bench_packed_fused", "bench_blockin", "bench_shufflenet_fused",
          "calibrate_act_variants", "tune_task_signal")


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def _jax_tool(name):
    """A JAX tool imported from its file (``tools/`` is no package); only
    for tools whose import changes no JAX setting."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------ the roofline
def _jax_roofline_literals():
    """(specs, quantize rows) of ``tools/bench_roofline.py::main``, read
    from its source."""
    tree = ast.parse((TOOLS / "bench_roofline.py").read_text())
    specs = quant = None
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "specs"
                for t in node.targets):
            specs = ast.literal_eval(node.value)
        if isinstance(node, ast.For) and isinstance(node.iter, ast.List) \
                and isinstance(node.target, ast.Tuple) \
                and len(node.target.elts) == 4:
            quant = ast.literal_eval(node.iter)
    return specs, quant


@pytest.fixture(scope="module")
def resnet_engines():
    """{packed: engine}: the float-frozen and the packed fused ResNet-50 at
    batch 2, 32x32, seed 0, on the CPU."""
    from cnns_slfp_quantization_tpu_torch.serve import InferenceEngine

    return {packed: InferenceEngine("resnet", qbit=8, batch_size=2,
                                    image_size=32, pack_weights=packed,
                                    fused=True, seed=0, device="cpu")
            for packed in (False, True)}


@pytest.fixture
def shared_engines(resnet_engines, monkeypatch):
    """Every ResNet-50 tool's engine function returns the module's pair."""
    monkeypatch.setattr(bench_packed, "engines",
                        lambda size, dev: resnet_engines)
    monkeypatch.setattr(bench_packed_fused, "engine",
                        lambda packed, batch, size, dev:
                        resnet_engines[packed])
    monkeypatch.setattr(bench_blockin, "engine",
                        lambda batch, size, dev: resnet_engines[False])
    return resnet_engines


@pytest.fixture(scope="module")
def roofline(resnet_engines):
    """The roofline tool's main at 2x32x32, both placements: its lines
    (its engine is the tool's own: seed 0, the default policy)."""
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(buf):
        mp.setattr(bench_roofline, "engine",
                   lambda batch, size, dev: resnet_engines[False])
        assert bench_roofline.main(["--device", "cpu", "--batch", "2",
                                    "--size", "32"]) == 0
    return _json_lines(buf.getvalue())


def test_roofline_jax_rows_are_jax_tools_literals():
    """At 224 the port's JAX-placement rows are the JAX tool's: its 27
    conv + epilogue specs and its four block-input quantize rows (name,
    shape, count), and beside them its stem, maxpool and head rows."""
    specs, quant = _jax_roofline_literals()
    assert bench_roofline.jax_specs(224) == specs
    assert bench_roofline.jax_quantize_rows(224) == quant
    # the rows take their weights from an executor only when called
    blocks = collections.defaultdict(
        lambda: collections.defaultdict(lambda: None))
    fw = types.SimpleNamespace(stem=None, stem_k=7, blocks=blocks)
    rows = bench_roofline.rows(fw, [1.0] * 54, "jax", 2, 224, "cpu", None)
    jax_rows = [(r.name, r.count) for r in rows if r.jax]
    want = ([("stem(q+s2d conv7x7/2+bn)", 1), ("maxpool3x3/2", 1),
             ("head(avgpool+q+fc)", 1)]
            + [(s[0], s[-1]) for s in specs] + [(q[0], q[-1]) for q in quant])
    assert sorted(jax_rows) == sorted(want)
    # the one row JAX's list lacks: stage 0's input quantize (K1)
    assert [r.name for r in rows if not r.jax] == ["s1 input q @56x64"]


def _row(lines, policy, name):
    return next(r for r in lines if r.get("policy") == policy
                and r.get("op") == name)


def test_roofline_counts_operations_and_bytes(roofline):
    """Each product's operations are 2*M*N*K of JAX's shapes (plus the
    elementwise kernels' per-element count), and two rows' bytes follow
    the port's dtypes: K2 reads bf16 activations and weights and writes
    conv1's output as float32; the downsample widens its bf16 input to
    float32 for cuDNN, which writes float32, then K3 writes bf16."""
    b, k3 = 2, bench_roofline.K3_OPS
    for name, hw, cin, cout, k, stride, res, q, count in \
            bench_roofline.jax_specs(32):
        r = _row(roofline, "jax", name)
        assert r["count"] == count
        oh = hw // stride
        product = 2 * b * oh * oh * cout * cin * k * k
        extra = b * oh * oh * cout * k3 if k == 3 or (k == 1 and not q
                                                        and not res) else 0
        assert r["gflops"] * 1e9 == pytest.approx(product + extra, rel=1e-12)
    # s2.conv1: K2, quantize prologue, M = 2*4*4, K = 512, N = 128
    m, kk, n = 2 * 4 * 4, 512, 128
    r = _row(roofline, "jax", "s2.conv1 1x1 512->128 @4")
    assert r["MB"] * 1e6 == pytest.approx(
        m * kk * 2 + kk * n * 2 + n * 8 + m * n * 4, rel=1e-12)
    # s2.b0.down: 2x8x8x256 bf16 -> f32 copy, cuDNN 1x1/2 to 2x4x4x512,
    # K3 raw (no ReLU) to bf16
    x, y, w = 2 * 8 * 8 * 256, 2 * 4 * 4 * 512, 512 * 256
    want = (x * 2 + x * 4) + (x * 4 + w * 4 + y * 4) + (y * 4 + 512 * 8
                                                        + y * 2)
    assert _row(roofline, "jax", "s2.b0.down 1x1/2 256->512")["MB"] * 1e6 \
        == pytest.approx(want, rel=1e-12)


def test_roofline_rows_count_the_executors_launches(roofline):
    """Each kernel class's per-forward rows add up to the launches the
    executor's counters give on the card at batch 64: JAX's placement K1
    3, K2 32, K3 21; the default K1 5, K2 18, K3 14, K6 7.  The summary
    prints JAX's keys."""
    summ = {s["policy"]: s for s in roofline if "summary" in s}
    assert summ["jax"]["row_launches"] == {"K1": 3, "K2": 32, "K3": 21}
    assert summ["default"]["row_launches"] == {"K1": 5, "K2": 18, "K3": 14,
                                               "K6": 7}
    for s in summ.values():
        for key in ("total_ms", "total_roofline_ms", "roofline_frac",
                    "implied_img_per_sec"):
            assert key in s
        assert s["total_ms"] is None        # no device time on the CPU
        assert s["total_roofline_ms"] > 0 and not s["rows_above_bound"]
    for r in roofline:
        if "op" in r:
            for key in ("op", "count", "ms", "MB", "GBps", "gflops",
                        "tflops", "roofline_ms", "roofline_frac", "bound",
                        "total_ms", "total_roofline_ms"):
                assert key in r, (r["op"], key)


def test_bound_is_the_larger_of_bytes_and_operations():
    """The one home of the H100's peaks and the bound formula, which
    ``chip_smoke.py`` imports."""
    ms, by = bench_roofline.bound_ms(3.35e9, 1.0, bench_roofline.F32_OPS)
    assert (ms, by) == (pytest.approx(1.0), "bytes")
    ms, by = bench_roofline.bound_ms(1.0, 989e9, bench_roofline.BF16_FLOPS)
    assert (ms, by) == (pytest.approx(1.0), "operations")
    src = (REPO / "chip_smoke.py").read_text()
    assert "def bound_ms" not in src and "HBM_BYTES_PER_S = " not in src


# ---------------------------------------------------- the QAT step by class
def test_dsgd_noq_bit_equal_to_jax():
    """``DSGDNoQ`` against JAX's ``_dsgd_noq`` (its tool's own function)
    over 4 steps on 4096 parameters, bit for bit; the raw update sits on
    both sides of the tolerance."""
    jax_tool = _jax_tool("bench_train_sites")
    rng = np.random.default_rng(5)
    w0 = rng.normal(0, 0.5, 4096).astype(np.float32)
    grads = [(rng.normal(0, 1, 4096) * 10.0 ** rng.uniform(-4, -1, 4096))
             .astype(np.float32) for _ in range(4)]
    d1 = np.abs(0.01 * (grads[0] + 5e-4 * w0))
    assert (d1 < 1e-4).sum() > 100 and (d1 >= 1e-4).sum() > 100
    want, _ = _jax_traj(jax_tool._dsgd_noq(0.01), w0, grads)
    got, _ = _port_traj(lambda p: bench_train_sites.DSGDNoQ(p, 0.01), w0,
                        grads)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32),
                                      err_msg=f"step {i}")


def test_train_sites_main_prints_jax_keys(monkeypatch, capsys):
    """Every variant builds and steps on the plain versions (one step each:
    the scan's timing is a device measurement), and the line has JAX's
    keys with the three differences as JAX takes them."""
    calls = []

    def one_step(step, state, x, y, steps=8):
        step(state, x, y)
        calls.append(type(state.optimizer).__name__)
        return 100.0 + len(calls)

    monkeypatch.setattr(profiling, "scan_train_throughput", one_step)
    assert bench_train_sites.main(["--device", "cpu", "--nets", "mobilenet",
                                   "--batch", "2", "--steps", "1"]) == 0
    out = _json_lines(capsys.readouterr().out)[-1]
    assert calls == ["QSGD", "DSGDNoQ", "QSGD", "QSGD", "QSGD"]
    assert set(out["img_per_sec"]) == set(bench_train_sites.VARIANTS)
    ms = {k: 2 / v * 1e3 for k, v in out["img_per_sec"].items()}
    assert out["step_ms"] == pytest.approx(ms)
    assert out["cost_ms"] == pytest.approx({
        "optimizer_2x_quantize": ms["prod"] - ms["opt_noq"],
        "fwd_weight_quantize": ms["prod"] - ms["fwd_nowq"],
        "fwd_act_quantize": ms["fwd_nowq"] - ms["fwd_none"]})


def test_train_sites_variants_differ_only_where_they_should():
    """``fwd_nowq`` holds Q(w/Kw) values that still train; ``fwd_none`` is
    a qbit-32 model; the optimizers are DSGD, DSGDNoQ and SGD."""
    from cnns_slfp_quantization_tpu_torch.ops import freeze

    dev = torch.device("cpu")
    st, _ = bench_train_sites.variant("mobilenet", "fwd_nowq", 2, 32, dev)
    layers = freeze.quant_layers(st.model)
    assert layers and all(lay.frozen_weights and lay.weight.requires_grad
                          for _, lay in layers)
    st, _ = bench_train_sites.variant("mobilenet", "fwd_none", 2, 32, dev)
    assert st.model.qbit == 32 and st.optimizer.qbit == 8
    kinds = {k: bench_train_sites.variant("mobilenet", k, 2, 32, dev)[0]
             .optimizer for k in ("prod", "opt_noq", "opt_sgd")}
    assert (kinds["prod"].rule, kinds["opt_sgd"].rule) == ("dsgd", "sgd")
    assert isinstance(kinds["opt_noq"], bench_train_sites.DSGDNoQ)


# ------------------------------------------------- act-variant calibration
def test_calibration_optimizer_is_the_optax_chain():
    """``make_optimizer`` against ``optax.chain(add_decayed_weights(5e-4),
    sgd(0.05, momentum=0.9))`` jitted, bit for bit over 3 steps."""
    rng = np.random.default_rng(9)
    w0 = rng.normal(0, 0.5, 4096).astype(np.float32)
    grads = [rng.normal(0, 0.1, 4096).astype(np.float32) for _ in range(3)]
    want, _ = _jax_traj(optax.chain(optax.add_decayed_weights(5e-4),
                                    optax.sgd(0.05, momentum=0.9)), w0, grads)
    got, _ = _port_traj(calibrate_act_variants.make_optimizer, w0, grads)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32),
                                      err_msg=f"step {i}")


def _jax_source_text(act, train_steps, calib_images):
    """The ``source`` f-string of JAX's ``calibrate_variant``, evaluated."""
    tree = ast.parse((TOOLS / "calibrate_act_variants.py").read_text())
    node = next(k.value for k in ast.walk(tree)
                if isinstance(k, ast.keyword) and k.arg == "source")
    return eval(compile(ast.Expression(node), "source", "eval"),
                {"act": act, "train_steps": train_steps,
                 "calib_images": calib_images})


def test_calibrate_main_writes_the_shipped_keys(tmp_path, capsys):
    """``main`` at 2x32x32 (no training step: the optimizer is held above)
    writes a JSON with the shipped file's keys, a constant per layer, and
    JAX's ``source`` text for the same arguments; the shipped constants
    stay JAX's."""
    assert calibrate_act_variants.main(
        ["--device", "cpu", "--train_steps", "0", "--batch", "2", "--size",
         "32", "--calib_images", "4", "--acts", "stl", "--out_dir",
         str(tmp_path)]) == 0
    assert "wrote" in capsys.readouterr().out
    got = json.loads((tmp_path / "resnet50_stl_imgnet.json").read_text())
    name = "resnet50_stl_imgnet.json"
    shipped = json.loads((PORT / "calib" / "constants" / name).read_text())
    jax = json.loads((REPO / "cnns_slfp_quantization_tpu" / "calib" /
                      "constants" / name).read_text())
    assert list(got) == list(shipped)
    assert [len(got[k]) for k in ("ka_max", "kw_max")] == \
        [len(shipped[k]) for k in ("ka_max", "kw_max")]
    assert got["divisor"] == 15.5
    assert got["source"] == _jax_source_text("stl", 0, 4)
    for key in ("divisor", "ka_max", "kw_max"):
        assert shipped[key] == jax[key], key


# ------------------------------------------------------------ task probe
def test_probe_prints_jax_keys(capsys):
    assert tune_task_signal.main(
        ["--device", "cpu", "--net", "mobilenet", "--signals", "0.25",
         "--train_steps", "2", "--eval_images", "8"]) == 0
    row = _json_lines(capsys.readouterr().out)[-1]
    assert set(row) == {"net", "signal", "classes", "proto_res",
                        "train_steps", "fp32_top1"}
    assert (row["classes"], row["proto_res"]) == (100, 4)
    assert 0.0 <= row["fp32_top1"] <= 100.0


# ------------------------------------------------ profiling's record filter
def _ev(name, start, us=1.0):
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(
            start=start, elapsed_us=lambda us=us: us))


def test_traces_count_only_what_follows_the_last_marker():
    """``print_forward_profile``, ``phase_profile``, ``busy_ms`` and
    ``kernel_profile`` read a trace from its marker kernel on (a lead-in
    call and the marker go first): records before it, however ordered,
    are dropped; a trace without it raises."""
    evs = [_ev("k_after", 50, 2.0), _ev("lead_in", 5), _ev(
        "void spin_kernel(long)", 10), _ev("k_first", 20, 3.0),
        _ev("void spin_kernel(long)", 30), _ev("k_after", 40, 2.0)]
    kept = profiling.after_marker(evs)
    assert [e.name for e in kept] == ["k_after", "k_after"]
    assert profiling.by_name(kept, 2) == [("k_after", 0.002, 1.0)]
    with pytest.raises(RuntimeError, match="marker"):
        profiling.after_marker([_ev("lead_in", 1)])


def test_kernel_profile_gives_up_on_a_lost_marker(monkeypatch):
    """A trace that keeps losing its marker is retried with twice the
    lead-in, ``LEAD_DOUBLINGS`` times, and then raises: the lead-in does
    not grow without end."""
    leads = []
    calls = []

    @contextlib.contextmanager
    def lost(lead_in):
        before = len(calls)
        lead_in()
        leads.append(len(calls) - before)
        raise profiling.MarkerLost("the trace lost its marker kernel")
        yield []

    fake = types.SimpleNamespace(
        cuda=types.SimpleNamespace(synchronize=lambda: None))
    monkeypatch.setattr(profiling, "_require_cuda", lambda: fake)
    monkeypatch.setattr(profiling, "_hand_launches", lambda: 0)
    monkeypatch.setattr(profiling, "marked_trace", lost)
    with pytest.raises(profiling.MarkerLost, match="marker"):
        profiling.kernel_profile(lambda: calls.append(1), 2, lead=16)
    assert leads == [16 * 2 ** i
                     for i in range(profiling.LEAD_DOUBLINGS + 1)]


# ----------------------------------------------- the tools that serve
def test_packed_main_prints_jax_configs(shared_engines, capsys):
    assert bench_packed.main(["--device", "cpu", "--batches", "2", "--steps",
                              "1", "--size", "32"]) == 0
    row = _json_lines(capsys.readouterr().out)[-1]
    assert set(row) == {"batch", "float", "packed-torch", "packed-kernel"}
    assert row["batch"] == 2 and all(row[k] > 0 for k in bench_packed.CONFIGS)


def test_packed_fused_main_weights_and_top1(shared_engines, capsys):
    """The packed executor's logits are the float one's bit for bit (its
    codes decode to the float-frozen bf16 values), and its weights take
    fewer bytes: the 1x1 convs' codes a quarter of their bf16 values."""
    assert bench_packed_fused.main(["--device", "cpu", "--batch", "2",
                                    "--steps", "1", "--size", "32"]) == 0
    rows = _json_lines(capsys.readouterr().out)
    assert [r.get("config") for r in rows] == ["float_fused", "packed_fused",
                                               None]
    for r in rows[:2]:
        assert {"config", "weight_MB", "img_per_sec"} <= set(r)
        assert r["finite"]
    flt, pk, cmp = rows
    assert pk["top1"] == flt["top1"]
    assert cmp["bit_equal"] and cmp["max_abs_delta"] == 0.0
    assert pk["weight_MB_by_dtype"]["uint8"] * 2 == pytest.approx(
        flt["weight_MB_by_dtype"]["bfloat16"]
        - pk["weight_MB_by_dtype"].get("bfloat16", 0.0), rel=1e-9)
    assert pk["weight_MB"] < flt["weight_MB"]


def test_packed_fused_compare_sees_one_flipped_bit():
    """The packed-against-float check fails on logits one bit apart."""
    a = np.random.default_rng(3).normal(0, 1, (4, 10)).astype(np.float32)
    b = a.copy()
    b.view(np.uint32)[2, 7] ^= 1
    assert bench_packed_fused.compare(a, a.copy())["bit_equal"]
    got = bench_packed_fused.compare(a, b)
    assert not got["bit_equal"] and 0.0 < got["max_abs_delta"] < 1e-6


def test_blockin_main_guard(shared_engines, capsys):
    assert bench_blockin.main(
        ["--device", "cpu", "--batch", "2", "--steps", "1", "--size", "32",
         "--modes", "consumer", "pallas_dual", "producer", "packed"]) == 0
    lines = _json_lines(capsys.readouterr().out)
    assert [r["blockin_fuse"] for r in lines if "blockin_fuse" in r] == [
        "consumer", "pallas_dual", "producer", "packed"]
    guard = {g["mode"]: g for g in lines if "mode" in g}
    assert guard["pallas_dual"]["outputs_bit_identical"]
    assert guard["pallas_dual"]["max_abs_delta"] == 0.0
    # the producer quantizes the f32 value, not the bf16 raw output
    assert {"outputs_bit_identical", "max_abs_delta"} <= set(guard["packed"])


def test_shufflenet_main_gate(capsys):
    assert bench_shufflenet_fused.main(["--device", "cpu", "--batch", "2",
                                        "--steps", "1"]) == 0
    lines = _json_lines(capsys.readouterr().out)
    gate = lines[0]
    assert gate["gate"] == "fused-vs-module" and gate["passed"]
    assert gate["cos"] > 0.98 and 0.0 <= gate["top1_match"] <= 1.0
    assert [r["config"] for r in lines[1:]] == ["module_bf16_frozen",
                                                "fused"]


class _NoHostTensors(types.ModuleType):
    """``torch`` as the executor's module sees it, but ``torch.tensor``
    (a tensor made from host data) refused."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def tensor(*args, **kwargs):
        raise AssertionError("a tensor made from host data in the forward")


@pytest.mark.parametrize("mode", ["consumer", "producer", "pallas_dual",
                                  "packed"])
def test_blockin_levers_make_no_host_tensor(resnet_engines, mode,
                                            monkeypatch):
    """Every block-input lever's forward can be captured in a CUDA graph:
    the executor makes no tensor from host data while it runs (a capture
    refuses the copy; ``packed`` made one per block until ``bench_blockin``
    timed it as a graph on the card)."""
    from cnns_slfp_quantization_tpu_torch.models import resnet50_fused as rf

    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    monkeypatch.setattr(rf, "torch", _NoHostTensors("torch"))
    y = rf.fused_apply(resnet_engines[False].executor, x,
                       policy=bench_blockin.POLICY,
                       _diag_blockin_fuse=mode)
    assert y.shape == (2, 1000)


# ----------------------------------------------------- device and imports
@pytest.mark.parametrize("name", PORTED)
def test_tool_runs_on_the_card_unless_told(name, monkeypatch):
    """Every tool defaults to the card and raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(
        f"cnns_slfp_quantization_tpu_torch.utils.{name}")
    argv = (["--net", "mobilenet", "--signals", "0.1"]
            if name == "tune_task_signal" else [])
    with pytest.raises(RuntimeError, match="--device cpu"):
        mod.main(argv)


@pytest.mark.parametrize("name", PORTED)
def test_tool_imports_neither_jax_nor_tools(name):
    """No tool imports JAX, the JAX package or the JAX tools."""
    src = (PORT / "utils" / f"{name}.py").read_text()
    for node in ast.walk(ast.parse(src)):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module] if isinstance(node, ast.ImportFrom)
                 and node.module else [])
        for mod in names:
            assert mod.split(".")[0] not in (
                "jax", "jaxlib", "flax", "optax", "tools",
                "cnns_slfp_quantization_tpu"), mod
