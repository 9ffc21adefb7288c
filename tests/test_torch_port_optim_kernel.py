"""K7, QSGD's update as one kernel over every parameter
(``kernels/optim.py``, ``csrc/optim.cu``), and the route ``QSGD.step``
takes.

On the CPU: the host's chunk plan covers every element of every tensor
once, each launch's arguments fit CUDA's limit, the Python mirror of the
C plan names its fields in the C order, and CPU tensors and a subclass
with its own rule take the plain route (the ``optim.plain`` counter).  The
``card`` tests need a CUDA device and skip without one: the kernel bit for
bit against the plain version on ResNet-50's 161 parameter shapes under
every rule, with values on SLFP bin edges, near the tolerance, subnormal
and -0.0, and a captured step's replays against eager steps.  On the card
(this file imports no JAX, and the tests' conftest does), in a process of
its own: its last test traces a replay, and on the H100 a trace taken
after others in one process can lose its records (the tracing file's
card tests read such traces):

    python3 -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_port_optim_kernel.py -m card
"""

import ctypes
import gc
import pathlib
import re

import numpy as np
import pytest
import torch

from cnns_slfp_quantization_tpu_torch import models
from cnns_slfp_quantization_tpu_torch.kernels import optim as k7
from cnns_slfp_quantization_tpu_torch.ops import sfp
from cnns_slfp_quantization_tpu_torch.train import loop, optimizers
from cnns_slfp_quantization_tpu_torch.utils import profiling
from cnns_slfp_quantization_tpu_torch.utils.bench_train_sites import DSGDNoQ

# the suite runs in several processes at once: one intra-op thread each
torch.set_num_threads(1)

CU = (pathlib.Path(k7.__file__).resolve().parent.parent / "csrc"
      / "optim.cu")


def _resnet50_sizes():
    """ResNet-50's parameter shapes in the model's order (161 tensors)."""
    model = models.create_model("resnet", 8, compute_dtype=torch.bfloat16,
                                image_size=224)
    return [tuple(p.shape) for p in model.parameters()]


RESNET50 = None


def resnet50_shapes():
    global RESNET50
    if RESNET50 is None:
        RESNET50 = _resnet50_sizes()
    return RESNET50


# ---------------------------------------------------------------------------
# CPU: the plan, the arguments, the route
# ---------------------------------------------------------------------------


def _covered(sizes):
    """How often each element of each tensor is written under the plan, as
    the kernel assigns them: each block's chunk in 4-element vectors, then
    a scalar tail (a tensor that takes no vectors is all tail)."""
    hits = [np.zeros(int(n), np.int64) for n in sizes]
    seen = []
    for s, first in k7.plan(sizes):
        k = len(first) - 1
        assert 1 <= k <= k7.MAX_TENSORS
        seen.extend(range(s, s + k))
        sub = sizes[s:s + k]
        for b in range(first[-1]):
            t, start, stop = k7.block_span(first, sub, b)
            assert 0 <= start < stop <= sub[t]
            nv = (stop - start) // 4
            hits[s + t][start:start + 4 * nv] += 1
            hits[s + t][start + 4 * nv:stop] += 1
    assert seen == list(range(len(sizes)))
    return hits


@pytest.mark.parametrize("sizes", [
    [1, 3, 64, 2_359_296, 4099],
    [4099],
    [0, 5, 0, 8192, 1],
    [4096 * 3 + 1] * 230,
], ids=["edges", "ragged", "empty", "three_launches"])
def test_plan_covers_every_element_once(sizes):
    for h in _covered(sizes):
        assert np.array_equal(h, np.ones_like(h))


def test_plan_covers_resnet50_in_two_launches():
    sizes = [int(np.prod(s)) for s in resnet50_shapes()]
    assert len(sizes) == 161 and sum(sizes) == 25_557_032
    assert len(k7.plan(sizes)) == 2
    for h in _covered(sizes):
        assert np.array_equal(h, np.ones_like(h))


def test_launch_arguments_fit_the_limit_the_plan_assumes():
    """One launch's plan is its only argument: under CUDA's 4 KB, with the
    C struct's field order, capacity and chunk."""
    assert ctypes.sizeof(k7.Plan) <= k7.ARG_BYTES
    text = CU.read_text()
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (k\w+) = (\d+);", text)}
    assert consts["kMaxTensors"] == k7.MAX_TENSORS
    assert consts["kThreads"] * consts["kUnroll"] * 4 == k7.CHUNK
    body = re.search(r"struct Plan \{(.*?)\n\};", text, re.S).group(1)
    body = re.sub(r"//.*", "", body)
    names = re.findall(r"(\w+)(?:\[[^\]]*\])?[,;]", body)
    assert names == [f for f, _ in k7.Plan._fields_]
    # a plan over ResNet-50's tensors: at most MAX_TENSORS a launch, each
    # launch's blocks in an int and a grid's x
    for _, first in k7.plan([int(np.prod(s)) for s in resnet50_shapes()]):
        assert len(first) - 1 <= k7.MAX_TENSORS and first[-1] < 2**31 - 1


def test_layout_ignores_the_strides_of_one_element_dims():
    """A 1x1 convolution's channels-last weight and the gradient cuDNN
    gives it (contiguous strides) hold their elements in one order: the
    kernel takes them; a transposed copy does not."""
    w = torch.empty_strided((256, 64, 1, 1), (64, 1, 64, 64))
    g = torch.zeros(256, 64, 1, 1)
    assert w.stride() != g.stride() and k7._dense(w) and k7._dense(g)
    assert k7._layout(w) == k7._layout(g)
    w3 = torch.zeros(64, 32, 3, 3).contiguous(
        memory_format=torch.channels_last)
    assert k7._layout(w3) != k7._layout(torch.zeros(64, 32, 3, 3))
    t = torch.zeros(8, 16).t()
    assert not k7._dense(t) and k7._layout(t) != k7._layout(
        torch.zeros(16, 8))


def _tiny(opt_fn, device="cpu"):
    g = torch.Generator().manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(12, 16), torch.nn.ReLU(),
                                torch.nn.Linear(16, 5)).to(device)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    opt = opt_fn(model.parameters())
    x = torch.randn(8, 12, generator=g).to(device)
    y = torch.randint(0, 5, (8,), generator=g).to(device)
    return model, opt, x, y


def _one_step(model, opt, x, y):
    opt.zero_grad()
    torch.nn.functional.cross_entropy(model(x), y).backward()
    opt.step()


@pytest.mark.parametrize("make", [
    lambda ps: optimizers.dsgd(ps, 0.01, 8, track_stats=True),
    lambda ps: optimizers.ssgd(ps, 0.01, 8),
    lambda ps: optimizers.sgd(ps, 0.01, nesterov=True),
    lambda ps: DSGDNoQ(ps, 0.01),
], ids=["dsgd", "ssgd", "sgd", "dsgd_noq"])
def test_cpu_steps_take_the_plain_route(make):
    model, opt, x, y = _tiny(make)
    before = profiling.counters()
    kernel_launches = k7.qsgd_update.launches
    with profiling.recording():
        for _ in range(2):
            _one_step(model, opt, x, y)
    _one_step(model, opt, x, y)         # not recorded: not counted
    after = profiling.counters()
    assert after.get("optim.plain", 0) - before.get("optim.plain", 0) == 2
    assert after.get("optim.kernel", 0) == before.get("optim.kernel", 0)
    assert k7.qsgd_update.launches == kernel_launches


def test_route_follows_the_device_and_the_rule():
    """On the card QSGD's own rules take the kernel; a subclass that
    overrides ``_scale`` (``DSGDNoQ``: the rule without its quantizes)
    keeps the plain route, which computes its rule."""
    cuda = torch.device("cuda")
    ps = [torch.nn.Parameter(torch.zeros(3))]
    for opt in (optimizers.dsgd(ps, 0.01, 8), optimizers.dsgd(ps, 0.01, 7),
                optimizers.ssgd(ps, 0.01, 8), optimizers.sgd(ps, 0.01)):
        assert opt._on_kernel(cuda) and not opt._on_kernel(
            torch.device("cpu"))
    noq = DSGDNoQ(ps, 0.01)
    assert not noq._on_kernel(cuda) and not noq._on_kernel(
        torch.device("cpu"))


def test_cpu_wrapper_is_the_plain_version():
    """On CPU tensors the wrapper runs the plain version: the same bits and
    counts, no launch counted."""
    shapes = [(5, 3), (64,), (7,)]
    out = {}
    for fn in (k7.qsgd_update, k7.qsgd_update_plain):
        r = np.random.default_rng(3)
        ps = [torch.from_numpy(r.standard_normal(s).astype(np.float32))
              for s in shapes]
        gs = [torch.from_numpy(r.standard_normal(s).astype(np.float32))
              for s in shapes]
        bs = [torch.from_numpy(r.standard_normal(s).astype(np.float32))
              for s in shapes]
        before = k7.qsgd_update.launches
        counts = fn(ps, gs, bs, torch.tensor(np.float32(-0.5)), rule="dsgd",
                    qbit=8, weight_decay=5e-4, momentum=0.9, dampening=0.0,
                    nesterov=False, tol=1e-4, stats=True)
        assert k7.qsgd_update.launches == before
        out[fn] = (ps, bs, counts)
    (p1, b1, c1), (p2, b2, c2) = out.values()
    for a, b in zip(p1 + b1, p2 + b2):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert torch.equal(c1, c2)
    assert c1.shape == (3, 2) and c1.sum(1).tolist() == [15, 64, 7]


def _weight_bin_table():
    """``slfp.cuh::weight_bin_entry`` for t = 0..31, the same loop."""
    bounds = [int(v.view(np.int32)) & 0x7FFFFF for v in sfp._LOG_BIN_BOUNDS]
    out = []
    for t in range(32):
        start, lo, bound = t << 18, 0, (t + 1) << 18
        for i, b in enumerate(bounds):
            if b <= start:
                lo = i + 1
            elif b < bound:
                bound = b
        out.append((lo << 24) | bound)
    return np.array(out, np.int64)


def _weight_q_bits(x, qbit):
    """``slfp.cuh::slfp34_weight_f32`` (qbit 8) / ``sfp33_weight_f32``
    (qbit 7) on float32 ``x`` (no NaN), as int32 bits, step for step."""
    b = x.view(np.int32).astype(np.int64)
    sign_bit = b < 0
    a = b & 0x7FFFFFFF
    a = np.where(a < 0x00800000, 0, a)                     # ftz
    f32 = sfp._f32_bits
    if qbit == 8:
        tab = _weight_bin_table()
        val = np.array([((i >> 4) << 23) | sfp._P_TABLE[i & 15]
                        for i in range(17)], np.int64)
        mant = a & 0x7FFFFF
        e = tab[mant >> 18]
        out = (a & 0x7F800000) + val[(e >> 24) + (mant >= (e & 0xFFFFFF))]
        out = np.where(a > sfp.I32_CLAMP_SLFP, sfp.I32_CLAMP_SLFP, out)
    else:
        out = (a + 0x7FFFF + ((a >> 20) & 1)) & ~0xFFFFF
        out = np.where(a >= sfp.I32_CLAMP_SFP33, sfp.I32_CLAMP_SFP33, out)
    out = np.where(a < f32(0.125), f32(0.125), out)
    out = np.where(a < f32(0.0625), f32(1e-10), out)
    out = np.where(a == 0, 0, out)
    out = out | np.where(sign_bit, 0x80000000, 0)
    return out.astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("qbit", [8, 7])
def test_device_weight_quantizer_equals_the_plain_one(qbit):
    """The weight quantizer K7 runs (a 32-entry bin table and one compare
    of the mantissa field for SLFP<3,4>, a carry round for SFP<3,3>)
    gives ``ops/sfp.py::quantize_weight``'s bits: on every bin edge a few
    ulps either side, the floors and clamps, subnormals, zeros, infinities
    and random values over every exponent the quantizer keeps."""
    rng = np.random.default_rng(qbit)
    if qbit == 8:
        m = sfp._LOG_BIN_BOUNDS.astype(np.float64)
    else:
        m = (8.5 + np.arange(8)) / 8.0
    edges = np.concatenate([
        (m[None, :] * 2.0 ** np.arange(-5, 5)[:, None]).ravel(),
        [0.0625, 0.125, float(sfp.SLFP34_CLAMP), 15.0, 16.0]]).astype(
        np.float32)
    near = (edges.view(np.int32)[:, None]
            + np.arange(-4, 5)[None, :]).astype(np.int32).view(np.float32)
    x = np.concatenate([
        near.ravel(), -near.ravel(),
        (rng.standard_normal(200_000) * 2.0 ** rng.integers(
            -6, 5, 200_000)).astype(np.float32),
        rng.integers(1, 0x7FFFFF, 1000).astype(np.int32).view(np.float32),
        np.array([0.0, -0.0, np.inf, -np.inf, 1e30, -1e-30], np.float32)])
    want = sfp.quantize_weight(torch.from_numpy(x), qbit).numpy().view(
        np.int32)
    got = _weight_q_bits(x, qbit)
    bad = np.flatnonzero(got != want)
    assert bad.size == 0, [(float(x[i]), hex(got[i]), hex(want[i]))
                           for i in bad[:5]]


# ---------------------------------------------------------------------------
# Card: the kernel against the plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gc.collect()
    return torch.device("cuda", 0)


def _edges(qbit):
    """|values| where Q's bin changes, for exponents -4..3: SLFP<3,4>'s log
    bin bounds, SFP<3,3>'s mantissa midpoints, and the floors and clamps."""
    if qbit == 8:
        m = sfp._LOG_BIN_BOUNDS.astype(np.float64)
        top = float(sfp.SLFP34_CLAMP)
    else:
        m = (8.5 + np.arange(8)) / 8.0
        top = float(sfp.SFP33_MAX)
    e = np.arange(-4, 4, dtype=np.float64)
    vals = (m[None, :] * 2.0 ** e[:, None]).ravel()
    vals = np.concatenate([vals, [0.0625, 0.125, top]])
    return vals[vals <= 16].astype(np.float32)


def _draw(rng, n, qbit, lr, tol, wd):
    """(p, g, buf) of n elements: a third of p on a bin edge of Q, a few
    ulps either side, half of those with updates that may cross it; for
    qbit 32 a sixth of the updates |d1| within a few ulps of tol; a few
    subnormals and -0.0 in each operand."""
    p = (rng.standard_normal(n) * 0.05).astype(np.float32)
    g = (rng.standard_normal(n) * 0.02).astype(np.float32)
    buf = (rng.standard_normal(n) * 0.02).astype(np.float32)
    if qbit in (7, 8):
        on = rng.random(n) < 1 / 3
        edges = _edges(qbit)
        v = edges[rng.integers(len(edges), size=int(on.sum()))]
        v = v * np.where(rng.random(v.size) < 0.5, -1, 1).astype(np.float32)
        v = (v.view(np.int32) + rng.integers(-3, 4, v.size)).astype(
            np.int32).view(np.float32)
        p[on] = v
        # updates of up to 1e-4 of p either way: some cross the edge
        small = on & (rng.random(n) < 0.5)
        g[small] = (p[small] * rng.uniform(-1e-4, 1e-4, int(small.sum()))
                    / lr).astype(np.float32)
        buf[small] = 0
    else:
        # g + wd*p = +-(tol / lr) within 64 ulps: |d1| = lr * that
        near = rng.random(n) < 1 / 6
        k = int(near.sum())
        want = (tol / lr * (1 + rng.integers(-64, 65, k) * 2.0**-23)
                * np.where(rng.random(k) < 0.5, -1, 1))
        g[near] = (want - wd * p[near].astype(np.float64)).astype(np.float32)
        buf[near] = 0
    for a in (p, g, buf):
        sub = rng.random(n) < 0.01
        bits = rng.integers(1, 0x7FFFFF, int(sub.sum())).astype(np.int32)
        bits |= np.where(rng.random(bits.size) < 0.5, np.int32(-2**31), 0
                         ).astype(np.int32)
        a[sub] = bits.view(np.float32)
        a[rng.random(n) < 0.005] = -0.0
    return p, g, buf


# rule, qbit, momentum, dampening, nesterov, weight decay, stats
CONFIGS = {
    "dsgd8": ("dsgd", 8, 0.9, 0.0, False, 5e-4, True),
    "dsgd7": ("dsgd", 7, 0.9, 0.0, False, 5e-4, True),
    "dsgd32": ("dsgd", 32, 0.9, 0.0, False, 5e-4, True),
    "dsgd8_nesterov_damp": ("dsgd", 8, 0.9, 0.1, True, 5e-4, True),
    "dsgd8_no_momentum_no_wd": ("dsgd", 8, 0.0, 0.0, False, 0.0, False),
    "ssgd": ("ssgd", 8, 0.9, 0.0, False, 5e-4, False),
    "sgd": ("sgd", 32, 0.9, 0.0, False, 5e-4, False),
    "sgd_nesterov_damp": ("sgd", 32, 0.9, 0.1, True, 5e-4, False),
}


def _bits(ts):
    return [t.view(torch.int32) for t in ts]


@pytest.mark.card
@pytest.mark.parametrize("name", list(CONFIGS))
def test_card_kernel_bit_equal_to_plain_on_resnet50_shapes(card, name):
    rule, qbit, m, damp, nest, wd, stats = CONFIGS[name]
    lr, tol = 0.1, 1e-4
    shapes = resnet50_shapes()
    rng = np.random.default_rng(sum(map(ord, name)))
    ops = [_draw(rng, int(np.prod(s)), qbit, lr, tol, wd) for s in shapes]
    neg_lr = torch.tensor(np.float32(-lr), device=card)
    kw = dict(rule=rule, qbit=qbit, weight_decay=wd, momentum=m,
              dampening=damp, nesterov=nest, tol=tol, stats=stats)
    got = {}
    for fn in (k7.qsgd_update, k7.qsgd_update_plain):
        ps = [torch.from_numpy(o[0]).reshape(s).to(card)
              for o, s in zip(ops, shapes)]
        gs = [torch.from_numpy(o[1]).reshape(s).to(card)
              for o, s in zip(ops, shapes)]
        bs = ([torch.from_numpy(o[2]).reshape(s).to(card)
               for o, s in zip(ops, shapes)] if m else None)
        before = k7.qsgd_update.launches
        counts = fn(ps, gs, bs, neg_lr, **kw)
        torch.cuda.synchronize()
        launched = k7.qsgd_update.launches - before
        got[fn] = (ps, bs or [], counts, launched)
    (pk, bk, ck, nk), (pp, bp, cp, npl) = got.values()
    assert nk == 2 and npl == 0
    for what, a_list, b_list in (("p", pk, pp), ("buf", bk, bp)):
        for i, (a, b) in enumerate(zip(_bits(a_list), _bits(b_list))):
            diff = int((a != b).sum())
            assert diff == 0, (name, what, i, shapes[i], diff)
    if stats:
        assert torch.equal(ck, cp), (name, ck.sum(0), cp.sum(0))
        total = ck.sum(0).tolist()
        assert total[0] > 0 and total[1] > 0, total
    else:
        assert ck is None and cp is None


def _graph_model(device):
    """60 linear layers (120 parameter tensors: two launches a step)."""
    g = torch.Generator().manual_seed(0)
    layers = []
    for _ in range(60):
        layers += [torch.nn.Linear(16, 16), torch.nn.Tanh()]
    model = torch.nn.Sequential(*layers)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    return model.to(device)


@pytest.mark.card
@pytest.mark.parametrize("qbit", [8, 32])
def test_card_graph_replays_equal_eager_steps(card, qbit):
    """Three replays of a captured DSGD step give three eager steps'
    weights, momentum and counters bit for bit; the capture counts the
    kernel's two launches a step, and each step counts its route."""
    rng = np.random.default_rng(1)
    xs = [torch.from_numpy(rng.standard_normal((32, 16)).astype(
        np.float32)).to(card) for _ in range(3)]
    y = torch.from_numpy(rng.integers(0, 16, 32)).to(card)
    out = {}
    for mode in ("eager", "graph"):
        model = _graph_model(card)
        opt = optimizers.dsgd(model.parameters(), lambda c: 0.05 / (1 + c),
                              qbit, track_stats=True)
        state = loop.TrainState(model, opt)
        step = loop.make_train_step(model, opt)
        before = profiling.counters().get("optim.kernel", 0)
        with profiling.recording():
            if mode == "graph":
                run = loop.GraphedTrainStep(step, state, xs[0], y)
                assert run.launches["qsgd_update"] == 2, run.launches
            else:
                def run(x, y, state=state, step=step):
                    return step(state, x, y)
            for x in xs:
                run(x, y)
        torch.cuda.synchronize()
        kernel_steps = profiling.counters().get("optim.kernel", 0) - before
        # eager: one a step; graph: the warm-up step and the capture (a
        # replay runs no Python)
        assert kernel_steps == (3 if mode == "eager" else 2), kernel_steps
        out[mode] = (_bits([p.detach() for p in model.parameters()]),
                     _bits([opt.state[p]["momentum"]
                            for p in model.parameters()]),
                     {k: int(v) for k, v in opt.stats.items()}, opt.count)
    (pe, be, se, ce), (pg, bg, sg, cg) = out["eager"], out["graph"]
    assert all(torch.equal(a, b) for a, b in zip(pe, pg))
    assert all(torch.equal(a, b) for a, b in zip(be, bg))
    assert se == sg and ce == cg == 3, (se, sg, ce, cg)
    assert se["updated"] + se["stuck"] == 3 * sum(
        p.numel() for p in _graph_model("cpu").parameters())


@pytest.mark.card
def test_card_captured_optimizer_step_runs_k7_alone(card):
    """A captured DSGD ``step()`` (the QAT step's optimizer phase) replays
    as K7's two launches and no other device kernel: no copy into a flat
    vector, no float64 pass, no bin compare."""
    model = _graph_model(card)
    opt = optimizers.dsgd(model.parameters(), 0.01, 8)
    x = torch.ones(4, 16, device=card)
    model(x).square().sum().backward()
    opt.step()                       # the momentum buffers, eagerly
    graph, _, launches = profiling.capture(opt.step, card)
    assert {k: n for k, n in launches.items() if n} == {"qsgd_update": 2}
    prof = profiling.kernel_profile(graph.replay, 3)
    # per replay, as means over the profiled replays
    assert round(prof["kernels"]) == 2, prof
    assert round(prof["launches"]["qsgd_update"]) == 2, prof
    assert set(prof["classes"]) == {"K7"}, prof["classes"]
