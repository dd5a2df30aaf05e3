"""The trace's arithmetic on synthetic timelines: the idle share, the
placement of device operations in spans, the idle gaps and the
breakdown."""

import pytest

from bench_h100.harness import trace


def _span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur}


def _launch(corr, ts):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 1, "args": {"correlation": corr}}


def _kernel(name, corr, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def two_steps():
    """Two 100 us steps: each launches a forward kernel in "rasterise"
    and a backward one in "backward" (from the engine's thread, placed by
    time), one memset in "scene"; device busy 10 + 20 + 5 per step."""
    events = []
    for s, t0 in enumerate((0, 100)):
        events += [_span("step", t0, 100), _span("scene", t0, 10),
                   _span("rasterise", t0 + 10, 30),
                   _span("backward", t0 + 50, 40)]
        c = 10 * s
        events += [_launch(c + 1, t0 + 2), _launch(c + 2, t0 + 15),
                   _launch(c + 3, t0 + 60)]
        events += [_kernel("memset", c + 1, t0 + 5, 5, "gpu_memset"),
                   _kernel("raster_sweep_kernel<512, 3>", c + 2, t0 + 20,
                           10),
                   _kernel("grad_reduce_kernel<4, 256>", c + 3, t0 + 70,
                           20)]
    return events


def test_idle_share_is_one_less_the_union_over_the_window():
    t = trace.Trace(two_steps(), steps=2)
    assert t.window == (0, 200)
    assert t.busy_s == pytest.approx(70e-6)
    # Overlapping operations count once.
    t = trace.Trace(two_steps() + [_kernel("copy", 99, 20, 10,
                                           "gpu_memcpy")], steps=2)
    assert t.busy_s == pytest.approx(70e-6)


def test_a_device_only_trace_takes_the_hosts_window():
    events = [e for e in two_steps() if e["cat"] != "user_annotation"]
    t = trace.Trace(events, steps=2, window_s=250e-6)
    assert t.window_s == pytest.approx(250e-6)
    assert t.window[0] == 5          # from the first operation
    assert t.busy_s == pytest.approx(70e-6)


def test_operations_are_placed_in_the_innermost_span_of_their_launch():
    t = trace.Trace(two_steps(), steps=2)
    assert t.span_ms("rasterise") == pytest.approx(0.010)
    assert t.span_ms("backward") == pytest.approx(0.020)
    assert t.span_ms("scene") == pytest.approx(0.005)
    assert t.kernel_ms("raster_sweep_kernel") == pytest.approx(0.010)
    assert t.unplaced_share() == 0.0
    lost = trace.Trace(two_steps() + [_kernel("k", 77, 150, 35)], steps=2)
    assert lost.unplaced_share() == pytest.approx(35 / 105)


def test_idle_gaps_are_named_by_the_hosts_span():
    gaps = trace.Trace(two_steps(), steps=2).idle_gaps()
    assert sum(s for s, _ in gaps) == pytest.approx(130e-6)
    named = {}
    for seconds, name in gaps:
        named[name] = named.get(name, 0.0) + seconds
    # 0-5 scene; 10-20 rasterise; 30-70: 30-40 rasterise, 40-50 outside
    # the step's own spans, 50-70 backward (by the gaps' middles).
    assert set(named) <= {"scene", "rasterise", "backward",
                          trace.OUTSIDE}
    out = trace.breakdown(trace.Trace(two_steps(), steps=2),
                          trace.Trace(two_steps(), steps=2), top=2)
    assert len(out["device_ops"]) == 2 and len(out["idle_gaps"]) <= 2
    assert out["device_ops"][0][0].startswith("grad_reduce_kernel")
    assert out["device_ops"][0][1] == pytest.approx(40e-6)

