"""Training observability: windowed metric smoothing + scalar event writer
(the counterpart of vista_slam_tpu/train/metrics.py).

Capability-matched to the reference's MetricLogger/SmoothedValue (windowed
medians over the last N iterations, reference: utils/croco_misc.py:26-178)
and its TensorBoard scalars (reference: sta_model/train.py:316-323,428-431).
The scalar writer prefers torch's SummaryWriter (tensorboard event files);
when unavailable it falls back to a plain scalars.jsonl so long runs stay
inspectable either way.
"""

from __future__ import annotations

import json
import os
from collections import deque


class SmoothedValue:
    """Track a series and expose median/avg over a sliding window plus the
    global average (reference: croco_misc.py:26-101)."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.window = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1):
        self.window.append(float(value))
        self.total += float(value) * n
        self.count += n

    def synchronize_between_processes(self):
        """All-reduce count/total across torch.distributed processes so
        global_avg reflects every process — the window (and so median/avg)
        stays process-local, exactly like the reference's warning says
        (reference: utils/croco_misc.py:44-54, dist.all_reduce on
        [count, total]). No-op without an initialised process group of
        more than one process."""
        import torch
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
            return
        dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
        both = torch.tensor([float(self.count), self.total], dtype=torch.float64, device=dev)
        dist.all_reduce(both)
        self.count = int(both[0].item())
        self.total = float(both[1].item())

    @property
    def median(self) -> float:
        if not self.window:
            return float("nan")
        s = sorted(self.window)
        m = len(s)
        return s[m // 2] if m % 2 else 0.5 * (s[m // 2 - 1] + s[m // 2])

    @property
    def avg(self) -> float:
        return sum(self.window) / len(self.window) if self.window else float("nan")

    @property
    def global_avg(self) -> float:
        return self.total / self.count if self.count else float("nan")

    @property
    def max(self) -> float:
        return max(self.window) if self.window else float("nan")

    @property
    def value(self) -> float:
        return self.window[-1] if self.window else float("nan")

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max,
                               value=self.value)


class MetricLogger:
    """Dict of SmoothedValues with a compact one-line summary."""

    def __init__(self, window_size: int = 20):
        self.window_size = window_size
        self.meters: dict[str, SmoothedValue] = {}

    def update(self, **kwargs):
        for k, v in kwargs.items():
            if k not in self.meters:
                self.meters[k] = SmoothedValue(self.window_size)
            self.meters[k].update(float(v))

    def __getattr__(self, name):
        meters = self.__dict__.get("meters", {})
        if name in meters:
            return meters[name]
        raise AttributeError(name)

    def synchronize_between_processes(self):
        """Sync every meter's count/total across hosts (reference:
        croco_misc.py:103-106). Collective: every process must call."""
        for m in self.meters.values():
            m.synchronize_between_processes()

    def summary(self) -> str:
        return "  ".join(f"{k}: {m}" for k, m in self.meters.items())


class ScalarWriter:
    """Scalar event sink: TensorBoard event files when torch's SummaryWriter
    imports, scalars.jsonl otherwise; ``enabled=False`` is a no-op."""

    def __init__(self, log_dir: str, enabled: bool = True):
        self.enabled = enabled
        self._tb = None
        self._jsonl = None
        if not enabled:
            return
        os.makedirs(log_dir, exist_ok=True)
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir=log_dir)
        except ImportError:  # no tensorboard package
            self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")

    def add_scalar(self, tag: str, value: float, step: int):
        if not self.enabled:
            return
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))
        elif self._jsonl is not None:
            self._jsonl.write(json.dumps(
                {"tag": tag, "value": float(value), "step": int(step)}) + "\n")
            self._jsonl.flush()

    def flush(self):
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
        if self._jsonl is not None:
            self._jsonl.close()
