"""The reduction from a trace's raw events to the per-layer metrics, on a
made-up trace whose answers are known, and the K5 bound at the cells' shapes."""

from types import SimpleNamespace

import pytest
import torch

from benchmark import manifest, peaks, trace
from benchmark.counting import Call, total_flops
from benchmark.rooflines import k5

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Event:
    def __init__(self, name, kind, device, start, dur, corr=0, linked=0):
        self._v = (name, kind, device, start, dur, corr, linked)

    def name(self): return self._v[0]
    def activity_type(self): return self._v[1]
    def device_type(self): return self._v[2]
    def start_ns(self): return self._v[3]
    def duration_ns(self): return self._v[4]
    def correlation_id(self): return self._v[5]
    def linked_correlation_id(self): return self._v[6]


def _prof(events):
    results = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


def _run(iterations=2):
    config = manifest.config("drq_small")
    traffic = manifest.traffic("learn")
    return trace.Run(config=config, traffic=traffic,
                     calls=manifest.flops("drq_small").calls(config, traffic),
                     iterations=iterations, window_ns=(0, 0))


def test_spans_launches_union_and_idle():
    ms = 1_000_000
    spans = {"bench.window": [(0, 100 * ms)],
             "bench.learner": [(10 * ms, 30 * ms), (50 * ms, 70 * ms)],
             "bench.env": [(80 * ms, 85 * ms)]}
    events = [
        Event("cudaLaunchKernel", "cuda_runtime", CPU, 12 * ms, 1000, corr=1),
        Event("cudaLaunchKernel", "cuda_runtime", CPU, 55 * ms, 1000, corr=2),
        Event("cudaLaunchKernel", "cuda_runtime", CPU, 81 * ms, 1000, corr=3),
        Event("aten::mm", "cpu_op", CPU, 60 * ms, 1000, corr=40),
        # a kernel launched in the first learner span, and one overlapping it
        Event("dense_ln_tanh_fwd_kernel", "kernel", CUDA, 20 * ms, 10 * ms, corr=1),
        Event("sm90_gemm", "kernel", CUDA, 25 * ms, 10 * ms, corr=2),
        # linked through its CPU op only
        Event("elementwise", "kernel", CUDA, 61 * ms, 4 * ms, corr=99, linked=40),
        Event("render_pixels_kernel", "kernel", CUDA, 90 * ms, 20 * ms, corr=3),  # past the window
        Event("orphan", "kernel", CUDA, 70 * ms, 1 * ms, corr=77),
    ]
    run = trace.reduce(_prof(events), _run(), spans)
    assert run.window_ns == (0, 100 * ms)
    assert run.unlinked == 1
    assert [o.span for o in run.ops] == ["bench.learner", "bench.learner", "bench.learner",
                                         "bench.env", None]
    # busy: [20, 35] + [61, 65] + [70, 71] + [90, 100] = 30 ms of 100
    assert run.busy_s() == pytest.approx(0.030)
    assert manifest.metric("device_idle_share").read(run) == pytest.approx(0.70)
    assert manifest.metric("learner.host_ms").read(run) == pytest.approx(20.0)
    assert manifest.metric("learner.device_ms").read(run) == pytest.approx((10 + 10 + 4) / 2)
    assert manifest.metric("env.device_ms").read(run) == pytest.approx(20 / 2)
    assert manifest.metric("replay.device_ms").read(run) is None
    flops = 2 * total_flops(run.calls["iteration"])
    assert manifest.metric("mfu").read(run) == pytest.approx(100 * flops / (0.1 * peaks.BF16_FLOPS))
    k5_least = 2 * sum(k5.least_seconds(c) for c in run.calls["iteration"] if c.kind == "dense_ln_tanh")
    assert manifest.metric("roofline.k5").read(run) == pytest.approx(100 * k5_least / 0.010)
    gaps = dict(trace.breakdown(run)["idle_gaps"])
    # gaps [0, 20), [35, 61), [71, 90) begin outside every span; [65, 70) in the second learner's
    assert gaps == pytest.approx({"loop (no bench span)": 0.065, "bench.learner": 0.005})


def test_spans_keep_the_host_clock():
    spans = trace.Spans()
    with spans("bench.window"):
        with spans("bench.learner"):
            pass
    (w0, w1), = spans.spans["bench.window"]
    (l0, l1), = spans.spans["bench.learner"]
    assert w0 <= l0 <= l1 <= w1


def test_a_trace_without_its_window_is_refused():
    with pytest.raises(RuntimeError):
        trace.reduce(_prof([]), _run(), {})


def test_k5_bound_takes_the_larger_of_bytes_and_operations():
    wide = Call("dense_ln_tanh", 1024, 4096 * 256, ("fwd",), 1, ("linear", 1, 4096, 256))
    m, k, d = 1024, 4096, 256
    product = 2 * m * k * d / peaks.TF32_FLOPS + 15 * m * d / peaks.FP32_FLOPS
    moved = 4 * (m * k + k * d + d + 2 * d + m * d) / peaks.BYTES_PER_S
    assert k5.least_seconds(wide) == pytest.approx(max(product, moved))
    trained = wide._replace(passes=("fwd", "igrad", "wgrad"), count=2)
    assert k5.least_seconds(trained) == pytest.approx(
        2 * (max(product, moved) + max(12 * m * d / peaks.BYTES_PER_S, 18 * m * d / peaks.FP32_FLOPS)))


@pytest.mark.cuda
def test_k5_bound_is_below_the_kernels_time_at_the_cells_shapes():
    """At every K5 shape of both cells, the kernels take longer than the bound."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: K5 has no CPU mode")
    from serl_tpu_torch.networks.dense_layer_norm_tanh import dense_layer_norm_tanh

    traffic = manifest.traffic("learn")
    shapes = set()
    for name in ("drq_small", "drq_resnet10"):
        calls = manifest.flops(name).calls(manifest.config(name), traffic)["iteration"]
        shapes |= {(c.shape, c.rows, bool(set(c.passes) - {"fwd"})) for c in calls
                   if c.kind == "dense_ln_tanh"}
    g = torch.Generator(device="cuda").manual_seed(0)
    for (form, e, k, d), m, backward in sorted(shapes):
        x = torch.randn((e, m, k) if form == "member" else (m, k), device="cuda", generator=g)
        w = (torch.randn((d, k), device="cuda", generator=g) if form == "linear"
             else torch.randn((e, k, d), device="cuda", generator=g)) / k ** 0.5
        b = torch.zeros((d,) if form == "linear" else (e, d), device="cuda")
        gamma, beta = torch.ones(d, device="cuda"), torch.zeros(d, device="cuda")
        w.requires_grad_(backward)
        call = Call("dense_ln_tanh", m, k * d, ("fwd", "wgrad") if backward else ("fwd",), e,
                    (form, e, k, d))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        for _ in range(3):
            y = dense_layer_norm_tanh(x, w, b, gamma, beta, member_inputs=form == "member")
            if backward:
                y.sum().backward()
        start.record()
        for _ in range(20):
            y = dense_layer_norm_tanh(x, w, b, gamma, beta, member_inputs=form == "member")
            if backward:
                y.sum().backward()
        end.record()
        torch.cuda.synchronize()
        assert start.elapsed_time(end) / 20 * 1e-3 > k5.least_seconds(call), (form, e, m, k, d)
