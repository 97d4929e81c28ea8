"""Profiling helpers: named ranges, torch.profiler traces and a stage timer,
as in vista_slam_tpu/utils/profiling.py (reference: vista_slam/utils/
device.py:78-88, its NVTX range and nsys workflow). The per-stage
wall-clock ``time_dict`` lives on OnlineSLAM with the reference's keys.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace_range(name: str):
    """A named range: an NVTX range on a CUDA machine (seen by Nsight) and a
    ``record_function`` range in torch.profiler traces."""
    with contextlib.ExitStack() as stack:
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        stack.enter_context(torch.profiler.record_function(name))
        yield


@contextlib.contextmanager
def profile_to(logdir: str):
    """Trace the host and, where there is one, the CUDA device with
    torch.profiler; on exit the trace goes to ``<logdir>/trace.json``
    (Chrome trace format: chrome://tracing, Perfetto). Yields the
    profiler; its ``trace_path`` names the file."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.trace_path = os.path.join(logdir, "trace.json")
    with prof:
        yield prof
    prof.export_chrome_trace(prof.trace_path)


class StageTimer:
    """Accumulating wall-clock stage timer with the reference's schema."""

    def __init__(self, *stages: str):
        self.times = dict.fromkeys(stages, 0.0)

    @contextlib.contextmanager
    def __call__(self, stage: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.times[stage] = self.times.get(stage, 0.0) + time.time() - t0

    def summary(self) -> dict:
        out = dict(self.times)
        out["total"] = sum(self.times.values())
        return out
