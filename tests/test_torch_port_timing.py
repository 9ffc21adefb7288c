"""The host-side rules of the port's device timing, on the CPU:
``utils/profiling.py::whole_runs`` (which profiled runs ``kernel_ms``
counts) and the turns of ``utils/turns.py`` that the bench tools share.
The timing itself needs the card and refuses the CPU."""

import pytest
import torch

from cnns_slfp_quantization_tpu_torch.utils import profiling, turns


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
