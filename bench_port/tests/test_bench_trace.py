"""The trace's reading: busy time, and the device time of the work launched inside
each of the harness's spans, from a hand-made Chrome trace."""

from bench_port import trace


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "args": args,
            "tid": 1}


def test_span_device_time_counts_the_work_launched_inside_the_span():
    events = [
        _x(trace.WINDOW, "user_annotation", 0, 1000),
        _x("bench.optimizer", "user_annotation", 100, 50),
        _x("cudaLaunchKernel", "cuda_runtime", 110, 5, correlation=1),
        _x("cudaLaunchKernel", "cuda_runtime", 140, 5, correlation=2),
        _x("cudaLaunchKernel", "cuda_runtime", 300, 5, correlation=3),
        # launched inside the span, run after it ended
        _x("adam_a", "kernel", 200, 10, correlation=1),
        _x("adam_b", "kernel", 215, 20, correlation=2),
        # launched outside it
        _x("other", "kernel", 320, 40, correlation=3),
    ]
    r = trace.read(events)
    seconds, count = r["spans"]["optimizer"]
    assert count == 1
    assert abs(seconds - 30e-6) < 1e-12
    assert abs(r["busy_s"] - 70e-6) < 1e-12
    assert r["kernels"] == 3
    assert "window" not in r["spans"]


def test_untraced_seconds_repeats_the_calls_after_a_reset_until_the_least_time():
    import torch
    calls, resets = [], []
    t = trace.untraced_seconds(lambda i: calls.append(i), 3, torch.device("cpu"),
                               lambda: resets.append(1))
    assert t > 0
    assert len(calls) == 3 * len(resets)
    assert calls[:3] == [0, 1, 2]
