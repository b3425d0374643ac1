"""The reduction of a traced block, on synthetic profiler events: busy time
as a union, idle gaps by what the host was doing, device time by the range
on the launching thread, and the breakdown."""

from __future__ import annotations

import pytest

from portbench.trace import WINDOW, Trace, breakdown, category, innermost, reduce, union_length


def test_union_and_gaps():
    total, gaps = union_length([(5, 8), (0, 2), (1, 3), (8, 9)])
    assert total == 3 + 4 and gaps == [(3, 5)]


def test_innermost_takes_the_latest_started_open_event():
    events = [("outer", 0, 100), ("inner", 10, 20), ("late", 50, 60)]
    assert innermost(events, [5, 15, 25, 55, 150]) == ["outer", "inner", "outer", "late", None]


def _block():
    cpu = [(WINDOW, 0, 100, 1, 0),
           ("portbench.step", 10, 90, 1, 1),
           ("portbench.adamw", 70, 85, 1, 2),
           ("cudaLaunchKernel", 12, 13, 1, 101),      # the forward's launch, main thread
           ("ssd.cum", 20, 30, 2, 3),                 # the recompute, on the backward's thread
           ("cudaLaunchKernel", 21, 22, 2, 102),
           ("cudaLaunchKernel", 72, 73, 1, 103),
           ("aten::item", 90, 95, 1, 4)]
    device = [("gemm_kernel", 14, 40, 101), ("elementwise_kernel", 41, 60, 102),
              ("adam_kernel", 74, 80, 103), ("lost_issuer_kernel", 80, 82, 999),
              ("before_window", -10, -5, 104)]
    return reduce(device, cpu, {"portbench.step", "portbench.adamw", "ssd.cum"})


def test_reduce_attributes_device_time_to_the_issuing_threads_range():
    t = _block()
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx((40 - 14 + 60 - 41 + 82 - 74) * 1e-6)
    assert t.activities == 4 and t.unattributed == 1
    assert t.ranges == pytest.approx({"portbench.step": 26e-6, "ssd.cum": 19e-6,
                                      "portbench.adamw": 6e-6})
    assert t.kernel_time("kernel") == (4, pytest.approx(53e-6))


def test_reduce_labels_idle_gaps_by_the_host():
    t = _block()
    # 0-14 in the window before the step, 40-41 and 60-74 in the step, 82-100 from
    # inside the optimizer's range
    assert sum(t.gaps.values()) == pytest.approx(t.window_s - t.busy_s)
    assert t.gaps[WINDOW] == pytest.approx(14e-6)
    assert t.gaps["portbench.step"] == pytest.approx(15e-6)
    assert t.gaps["portbench.adamw"] == pytest.approx(18e-6)


def test_reduce_needs_the_window():
    with pytest.raises(ValueError):
        reduce([], [("aten::mm", 0, 1, 1, 0)], set())


def test_breakdown_keeps_the_ten_largest():
    t = Trace(window_s=1.0, busy_s=0.5, activities=20,
              kernels={f"k{i}_kernel": [1, i * 1e-3] for i in range(20)},
              gaps={f"aten::op{i}": i * 1e-4 for i in range(15)})
    b = breakdown(t)
    assert len(b["device_ops"]) == 10 and len(b["idle_gaps"]) == 10
    assert b["device_ops"][0] == ["torch k19_kernel", 19e-3]
    assert b["idle_gaps"][0] == ["aten::op14", pytest.approx(14e-4)]


@pytest.mark.parametrize("name,want", [
    ("void attn_bwd_dq_bf16_kernel<80>(...)", "attention backward kernels"),
    ("void ssd_bwd_inter_bf16_kernel(BwdPtrs, BwdArgs, int)", "ssd chunk scan backward kernels"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "matmul (cuBLAS)"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NNT", "matmul (cuBLAS)"),
    ("Memcpy DtoD (Device -> Device)", "Memcpy DtoD"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::AUnaryFunctor<float, "
     "float, float, at::native::binary_internal::MulFunctor<float> >, at::detail::Array<char*, "
     "2> >(int, at::native::AUnaryFunctor<float, float, float, "
     "at::native::binary_internal::MulFunctor<float> >, at::detail::Array<char*, 2>)",
     "torch MulFunctor<float>"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float> >(...)",
     "torch reduce_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctorOnSelf_add<float>,"
     " at::detail::Array<char*, 2> >(int, ...)", "torch CUDAFunctorOnSelf_add<float>"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<at::native::(anonymous "
     "namespace)::OpaqueType<2u>, unsigned int, 4, 64, 64>(...)", "torch CatArrayBatchedCopy"),
])
def test_categories(name, want):
    assert category(name) == want
