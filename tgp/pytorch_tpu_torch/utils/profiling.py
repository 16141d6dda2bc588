"""Profiling: the torch counterpart of the JAX package's
`utils/profiling.py`.

`trace(logdir)` profiles the block under `torch.profiler` (the host, and
the card when there is one) and writes a Chrome trace,
`<logdir>/trace.json`, which Perfetto and chrome://tracing open.
`step_timer(fn)` times each call of fn by the host's clock, after
synchronizing the card (kernels run asynchronously, so the clock read right
after a call would miss them).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; the trace goes to `<logdir>/trace.json`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        _sync()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class step_timer:
    """Measure each call's wall time of fn, the card synchronized first."""

    def __init__(self, fn):
        self.fn = fn
        self.times = []

    def __call__(self, *args, **kwargs):
        _sync()
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        _sync()
        self.times.append(time.perf_counter() - t0)
        return out

    @property
    def mean(self):
        return sum(self.times) / max(1, len(self.times))
