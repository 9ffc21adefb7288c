"""The host-side rules of the port's device timing, on the CPU:
``utils/profiling.py::whole_runs`` (which profiled runs ``kernel_ms``
counts) and the turns of ``utils/turns.py`` that the bench tools share.
The timing itself needs the card and refuses the CPU."""

import pytest
import torch

from cnns_slfp_quantization_tpu_torch.utils import profiling, turns

# the suite runs in several processes at once: one intra-op thread each
# (torch's default, a thread per core in each, spins on shared cores)
torch.set_num_threads(1)


@pytest.mark.parametrize("seen, floor, want", [
    # every run whole
    ([(10, 5.0), (10, 6.0), (10, 7.0)], 10, [5.0, 6.0, 7.0]),
    # a run that lost some of its kernel events reads low and is dropped
    ([(10, 5.0), (8, 4.0), (10, 6.0)], 10, [5.0, 6.0]),
    # library calls (no hand kernel): the fullest run sets the count
    ([(15, 9.0), (12, 7.0), (15, 9.5)], 0, [9.0, 9.5]),
    # more kernels than the hand launches (a split-K second pass)
    ([(10, 5.0), (10, 5.5)], 5, [5.0, 5.5]),
    # every run short of the launches known from the counts
    ([(4, 2.0), (4, 2.1)], 5, []),
    # the profiler recorded nothing at all
    ([(0, 0.0), (0, 0.0)], 0, []),
])
def test_whole_runs_count_only_runs_with_every_kernel(seen, floor, want):
    assert profiling.whole_runs(seen, floor) == want


def test_kernel_ms_refuses_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        profiling.kernel_ms(lambda: None)


def test_alternate_times_in_turns():
    """One untimed call of each, then a, b, b, a per pair; the values come
    back in turn order."""
    order = []

    def call(name):
        def run():
            order.append(name)
            return float(len(order))
        return run
    runs = turns.alternate({"a": call("a"), "b": call("b")}, 2)
    assert order == ["a", "b"] + ["a", "b", "b", "a"] * 2
    assert runs == {"a": [3.0, 6.0, 7.0, 10.0], "b": [4.0, 5.0, 8.0, 9.0]}


def test_compared_states_ratio_and_order():
    line = turns.compared({"x": [3.0, 4.0], "y": [1.0, 2.0]})
    assert line == ("x 3.0 / 4.0; y 1.0 / 2.0 images/s; x / y 2.333; every "
                    "x run above every y run: True, below: False")
    assert "above every y run: False, below: False" in turns.compared(
        {"x": [3.0, 1.5], "y": [1.0, 2.0]})


# device kernel names torch.profiler gave for a fused forward on an H100
_CAST = ("void at::native::unrolled_elementwise_kernel<at::native::"
         "direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}::"
         "operator()() const::{lambda()#7}::operator()() const::"
         "{lambda(float)#1}, std::array<char*, 2ul>, 4, TrivialOffset"
         "Calculator<1, unsigned int>, TrivialOffsetCalculator<1, unsigned "
         "int>, at::native::memory::LoadWithCast<1>, at::native::memory::"
         "StoreWithCast<1> >")
_SAME = ("void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_"
         "impl_nocast<at::native::direct_copy_kernel_cuda(at::TensorIterator"
         "Base&)::{lambda()#3}::operator()() const::{lambda()#12}::operator()"
         "() const::{lambda(c10::BFloat16)#1}>")
_NARROW = ("void at::native::vectorized_elementwise_kernel<8, at::native::"
           "bfloat16_copy_kernel_cuda(at::TensorIteratorBase&)::"
           "{lambda(float)#1}, std::array<char*, 2ul> >")


@pytest.mark.parametrize("name, want", [
    (_CAST, True),      # .to(torch.float32) of a bf16 tensor
    (_SAME, False),     # a layout copy of a bf16 tensor
    (_NARROW, False),   # float32 -> bf16 (the logits)
    ("void (anonymous namespace)::epilogue_slab<false, true, false, 2, "
     "true>((anonymous namespace)::Args)", False),
])
def test_profile_counts_only_the_widening_copies(name, want):
    assert profiling.is_f32_copy(name) is want


# ------------------------------------------------- the scans on the CPU
def test_scans_run_eager_on_the_cpu():
    """On CPU tensors both scans loop eager calls (no graph) over inputs
    perturbed per step, one untimed and three timed runs of ``steps``:
    the forward sees 4 * steps distinct inputs under inference mode, and
    the train state advances 4 * steps steps (``state.step`` and the
    optimizer's count).  ``graph=True`` refuses the CPU."""
    from cnns_slfp_quantization_tpu_torch import models
    from cnns_slfp_quantization_tpu_torch.train import loop, optimizers

    x = torch.randn(2, 8, 8, 3, generator=torch.Generator().manual_seed(0))
    seen = []

    def forward(xx):
        seen.append((float(xx.sum()), torch.is_inference_mode_enabled()))
        return xx * 2

    ips = profiling.scan_throughput(forward, x, steps=3)
    assert ips > 0 and len(seen) == 12 and all(mode for _, mode in seen)
    assert len({s for s, _ in seen[:3]}) == 3
    with pytest.raises(ValueError, match="CUDA"):
        profiling.scan_throughput(forward, x, graph=True)

    model = models.create_model("mobilenet", 32, generator=torch.Generator()
                                .manual_seed(0))
    opt = optimizers.sgd(model.parameters(), 1e-3)
    state = loop.TrainState(model, opt)
    step = loop.make_train_step(model, opt)
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    y = torch.tensor([3, 7])
    ips = profiling.scan_train_throughput(step, state, x, y, steps=2)
    assert ips > 0 and state.step == 8 and opt.count == 8
    with pytest.raises(ValueError, match="CUDA"):
        profiling.scan_train_throughput(step, state, x, y, graph=True)


@pytest.mark.parametrize("name", ["adam", "rmsprop", "dsgd"])
def test_graphed_train_step_refuses_what_it_cannot_capture(name):
    """A CUDA graph takes QSGD only (Adam and RMSprop read host scalars),
    and refuses a batch on the CPU, before anything runs."""
    from cnns_slfp_quantization_tpu_torch import models
    from cnns_slfp_quantization_tpu_torch.train import loop, optimizers

    model = models.create_model("mobilenet", 32, generator=torch.Generator()
                                .manual_seed(0))
    opt = optimizers.create_optimizer(name, model.parameters(), 1e-3, 8)
    state = loop.TrainState(model, opt)
    step = loop.make_train_step(model, opt)
    x, y = torch.zeros(2, 32, 32, 3), torch.zeros(2, dtype=torch.int64)
    match = "on the card" if name == "dsgd" else "host scalars"
    with pytest.raises(ValueError, match=match):
        loop.GraphedTrainStep(step, state, x, y)
    assert state.step == 0 and opt.count == 0


def test_capture_restores_what_its_warm_up_step_moved():
    """Before a capture, what the eager warm-up step moved goes back in
    place: the model's parameters and buffers, the optimizer's counters
    and state (a momentum buffer made since: zeros), ``state.step``, and
    the dropout generator, so that the first replay draws the masks the
    first eager step would."""
    from cnns_slfp_quantization_tpu_torch import models
    from cnns_slfp_quantization_tpu_torch.train import loop, optimizers

    model = models.create_model("mobilenet", 8, generator=torch.Generator()
                                .manual_seed(0))
    opt = optimizers.dsgd(model.parameters(), 1e-3, 8)
    state = loop.TrainState(model, opt)
    step = loop.make_train_step(model, opt)
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    y = torch.tensor([3, 7])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    saved = loop._snapshot(state, gen)
    first = torch.rand(16, generator=gen)
    step(state, x, y, gen)
    assert state.step == 1 and opt.count == 1
    assert not all(torch.equal(v, before[k])
                   for k, v in model.state_dict().items())
    loop._restore(state, saved, gen)
    assert state.step == 0 and opt.count == 0
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(not st["momentum"].any() for st in opt.state.values())
    assert torch.equal(torch.rand(16, generator=gen), first)


_ANON = "(anonymous namespace)::"


@pytest.mark.parametrize("name,want", [
    (f"void {_ANON}quantize_kernel<8, false, false, true, true>(void "
     f"const*, void*, long long, long long, float)", "act_quantize"),
    (f"void {_ANON}f32form_kernel<true>(void const*, void*, long long)",
     "slfp34_act_quantize"),
    (f"void gemm::gemm_kernel<2, 128, false, {_ANON}QmmEpi>(CUtensorMap_st, "
     f"CUtensorMap_st, gemm::Params, {_ANON}QmmEpi)", "qmm_fused"),
    (f"void gemm::gemm_kernel<1, 64, true, {_ANON}FusedEpi>(CUtensorMap_st, "
     f"CUtensorMap_st, gemm::Params, {_ANON}FusedEpi)", "fused_quant_matmul"),
    (f"void gemm::splitk_reduce<{_ANON}QmmEpi>(float const*, int, long long, "
     f"int, {_ANON}QmmEpi)", None),
    (f"void {_ANON}epilogue_slab<false, true, true, 0, true>({_ANON}Args)",
     "bn_epilogue"),
    (f"{_ANON}epilogue_any({_ANON}Args, bool, bool)", "bn_epilogue"),
    (f"void {_ANON}dw3x3_kernel<true, false, 1>({_ANON}Args)", "dw3x3"),
    (f"void {_ANON}chain_kernel<true>(CUtensorMap_st, CUtensorMap_st)",
     "bottleneck_chain"),
    (f"void {_ANON}qsgd_update_kernel<0, 8, false, true>({_ANON}Plan)",
     "qsgd_update"),
    ("void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm_64x64_16x6_tn_"
     "align4>(cutlass_80_tensorop_s1688gemm_64x64_16x6_tn_align4::Params)",
     None),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "FillFunctor<float>, std::array<char*, 1ul> >(int, at::native::"
     "FillFunctor<float>, std::array<char*, 1ul>)", None),
])
def test_hand_kernels_are_counted_by_their_trace_names(name, want):
    """``busy_ms`` counts a wrapper's launches in a trace by its kernel's
    name: each hand kernel's name matches its wrapper alone, and split-K's
    second pass, cuBLAS's and PyTorch's kernels match none."""
    import re

    got = [w for w, p in profiling.HAND_KERNELS.items() if re.search(p, name)]
    assert got == ([want] if want else [])


# a trace name of each hand kernel and of split-K's second pass -> its class
_HAND_NAMES = [
    (f"void {_ANON}quantize_kernel<8, false, false, true, true>(void "
     f"const*, void*, long long, long long, float)", "K1"),
    (f"void {_ANON}f32form_kernel<true>(void const*, void*, long long)",
     "K1"),
    (f"void gemm::gemm_kernel<2, 128, false, {_ANON}QmmEpi>(CUtensorMap_st, "
     f"CUtensorMap_st, gemm::Params, {_ANON}QmmEpi)", "K2"),
    (f"void gemm::splitk_reduce<{_ANON}QmmEpi>(float const*, int, long long, "
     f"int, {_ANON}QmmEpi)", "K2"),
    (f"void {_ANON}epilogue_slab<false, true, true, 0, true>({_ANON}Args)",
     "K3"),
    (f"{_ANON}epilogue_any({_ANON}Args, bool, bool)", "K3"),
    (f"void gemm::gemm_kernel<1, 64, true, {_ANON}FusedEpi>(CUtensorMap_st, "
     f"CUtensorMap_st, gemm::Params, {_ANON}FusedEpi)", "K4"),
    (f"void gemm::splitk_reduce<{_ANON}FusedEpi>(float const*, int, long "
     f"long, int, {_ANON}FusedEpi)", "K4"),
    (f"void {_ANON}dw3x3_kernel<true, false, 1>({_ANON}Args)", "K5"),
    (f"void {_ANON}chain_kernel<true>(CUtensorMap_st, CUtensorMap_st)",
     "K6"),
    (f"void {_ANON}qsgd_update_kernel<2, 32, true, false>({_ANON}Plan)",
     "K7"),
]


@pytest.mark.parametrize("name, want", _HAND_NAMES)
def test_kernel_class_names_each_hand_kernel(name, want):
    """A hand kernel's launches go to its own class, before any library
    substring (``gemm``, ``conv``), never to cuBLAS, cuDNN or the
    elementwise kernels; split-K's second pass goes with the GEMM whose
    epilogue type it carries."""
    assert profiling.kernel_class(name) == want


def test_kernel_class_covers_every_hand_kernel():
    """Every wrapper of ``HAND_KERNELS`` has a class and a sample name
    above that its pattern takes."""
    import re

    assert set(profiling.HAND_CLASSES) == set(profiling.HAND_KERNELS)
    for wrapper, pattern in profiling.HAND_KERNELS.items():
        assert any(re.search(pattern, n) and c == profiling.HAND_CLASSES[
            wrapper] for n, c in _HAND_NAMES), wrapper


@pytest.mark.parametrize("name, want", [
    ("void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm_64x64_16x6_tn_"
     "align4>(cutlass_80_tensorop_s1688gemm_64x64_16x6_tn_align4::Params)",
     "cuBLAS"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroup"
     "size1x1x1_execute_segment_k_off_kernel__5x_cublas", "cuBLAS"),
    ("void cublasLt::splitKreduce_kernel<32, 16, int, float, float, float, "
     "float, false, false, false>(cublasLt::cublasSplitKParams<float>, "
     "float const*, float const*, float*)", "cuBLAS"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
     "tilesize128x128x64_warpgroupsize1x1x1_g1_execute_segment_k_off_kernel"
     "__5x_cudnn", "cuDNN conv"),
    ("void cudnn::ops::nchwToNhwcKernel<float, float, float, false, true, "
     "(cudnnKernelDataType_t)2>(cudnn::ops::nchw2nhwc_params_t<float>, "
     "float const*, float*)", "cuDNN conv"),
    (_CAST, "elementwise"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "FillFunctor<float>, std::array<char*, 1ul> >(int, at::native::"
     "FillFunctor<float>, std::array<char*, 1ul>)", "elementwise"),
])
def test_kernel_class_keeps_the_library_classes(name, want):
    assert profiling.kernel_class(name) == want
