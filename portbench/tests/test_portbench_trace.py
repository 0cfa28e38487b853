"""The reduction of a profiler trace to busy and idle seconds, kernel
time by name and named idle gaps, on a hand-made trace."""

import pytest

from harness import trace


def ev(name, cat, ts, dur):
    return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur}


def test_busy_idle_kernels_and_gaps():
    events = [
        ev(trace.WINDOW, "user_annotation", 1000.0, 1000.0),
        ev("k_a", "kernel", 900.0, 200.0),        # clipped to [1000, 1100]
        ev("k_b", "kernel", 1100.0, 100.0),
        ev("k_a", "kernel", 1150.0, 100.0),       # overlaps k_b
        ev("Memcpy DtoH", "gpu_memcpy", 1500.0, 100.0),
        ev("k_c", "kernel", 1900.0, 200.0),       # clipped to [1900, 2000]
        ev("detect", "user_annotation", 1250.0, 300.0),
        ev("aten::copy_", "cpu_op", 1260.0, 100.0),
        ev("cudaGraphLaunch", "cuda_runtime", 1650.0, 20.0),
    ]
    out = trace.Trace()
    trace._read(events, out)
    assert out.window_s == pytest.approx(1000e-6)
    # busy: [1000, 1250] + [1500, 1600] + [1900, 2000]
    assert out.busy_s == pytest.approx(450e-6)
    assert out.kernel_s("k_a") == (pytest.approx(200e-6), 2)
    assert out.kernel_s("k_c")[0] == pytest.approx(100e-6)
    names = dict((n, s) for n, s in out.gaps)
    # gaps: [1250, 1500] midpoint 1375 under "detect" only; [1600, 1900]
    # midpoint 1750 under nothing
    assert names["detect"] == pytest.approx(250e-6)
    assert names["(no host op)"] == pytest.approx(300e-6)
    assert out.device_ops()[0][0] == "k_a"


def test_no_window_reads_nothing():
    out = trace.Trace()
    trace._read([ev("k", "kernel", 0.0, 1.0)], out)
    assert out.window_s == 0.0 and out.busy_s == 0.0 and not out.kernels
