"""The trace reader on a made-up event list: overlapping kernels count
once towards busy time, idle gaps are labelled by the innermost host event
running at their start, and metric name lists pick kernels by name."""

import pytest

from benchmark import trace

EVENTS = [  # (name, category, start µs, end µs)
    ("void trunk_resident_fwd<32>(TrunkArgs)", "kernel", 0.0, 10.0),
    ("sgemm_kernel", "kernel", 5.0, 15.0),  # overlaps the first
    ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 20.0, 22.0),
    ("void trunk_resident_bwd<32>(TrunkArgs)", "kernel", 40.0, 50.0),
    ("Optimizer.step#Adam.step", "gpu_user_annotation", 0.0, 60.0),  # spans kernels
    ("aten::copy_", "cpu_op", 14.0, 30.0),
    ("cudaMemcpyAsync", "cuda_runtime", 16.0, 19.0),  # inside aten::copy_
    ("cudaGraphLaunch", "cuda_runtime", 21.0, 45.0),
]


@pytest.fixture
def s():
    return trace.summarize(EVENTS, wall_s=100e-6)


def test_busy_is_the_union(s):
    assert s["busy_s"] == pytest.approx((15.0 + 2.0 + 10.0) * 1e-6)
    assert s["window_s"] == 100e-6


def test_kernels_leave_out_copies_and_annotations(s):
    assert s["kernel_count"] == 3
    assert set(s["kernels"]) == {EVENTS[0][0], EVENTS[1][0], EVENTS[3][0]}


def test_idle_gaps_by_host_label(s):
    gaps = dict(s["idle_gaps"])
    assert gaps["aten::copy_"] == pytest.approx(5e-6)  # 15 → 20
    assert gaps["cudaGraphLaunch"] == pytest.approx(18e-6)  # 22 → 40


def test_device_ops_by_time(s):
    ops = dict(s["device_ops"])
    assert ops["sgemm_kernel"] == pytest.approx(10e-6)
    assert list(ops)[-1].startswith("Memcpy")


def test_attribution_by_names(s):
    assert trace.attributed(s["kernels"], ["trunk_resident_fwd", "trunk_resident_bwd"]) == \
        pytest.approx(20e-6)
    assert trace.attributed(s["kernels"], ["no_such_kernel"]) == 0.0


def test_roofline_reader_returns_nothing_without_its_kernels():
    from benchmark.harness import read_metric

    ranks = [{**trace.summarize(EVENTS[1:3] + EVENTS[4:5], 1e-4), "epochs": 1,
              "work": {"trunk_ops": 1e6, "trunk_bytes": 1e6, "model_flops": 1e6}}]
    assert read_metric("kernels.trunk_roofline", {"ranks": ranks}) is None
    ranks = [{**trace.summarize(EVENTS, 1e-4), "epochs": 1,
              "work": {"trunk_ops": 1e6, "trunk_bytes": 1e6, "model_flops": 1e6}}]
    got = read_metric("kernels.trunk_roofline", {"ranks": ranks})
    assert got == pytest.approx(100 * max(1e6 / 67e12, 1e6 / 3.35e12) / 20e-6)


@pytest.mark.parametrize("metric,kernel", [
    ("kernels.spmm_roofline", "void (anonymous namespace)::rows_group<8>(int const*)")])
def test_propagation_rooflines_read_their_kernels(metric, kernel):
    from benchmark.harness import read_metric

    work = {"prop_ops": 1e6, "prop_bytes": 1e6}
    ranks = [{**trace.summarize(EVENTS, 1e-4), "work": work}]
    assert read_metric(metric, {"ranks": ranks}) is None  # the trunk's kernels only
    events = EVENTS + [(kernel, "kernel", 60.0, 70.0)]
    ranks = [{**trace.summarize(events, 1e-4), "work": work}]
    got = read_metric(metric, {"ranks": ranks})
    assert got == pytest.approx(100 * max(1e6 / 67e12, 1e6 / 3.35e12) / 10e-6)
