"""Observability: scalar metric writer, step timing and profiler traces
(counterpart of ``eegan_tpu/training/logging.py``).

* scalars go to an append-only ``metrics.jsonl`` (always) and to
  TensorBoard event files when ``torch.utils.tensorboard`` imports, as in
  the JAX package;
* `StepTimer` tracks wall-clock images/sec with warmup skipping; on a
  CUDA device its window opens after a synchronise, so that it holds no
  work queued before it;
* `trace()` wraps a block in a ``torch.profiler`` trace (host and, on a
  GPU, device activity), written as a Chrome trace, in place of
  ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, Optional

import torch


class MetricWriter:
    """Thread-safe scalar writer."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._lock = threading.Lock()
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # tensorboard is optional; metrics.jsonl is not
            SummaryWriter = None
        if SummaryWriter is not None:
            self._tb = SummaryWriter(log_dir)

    def write_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        clean = {k: float(v) for k, v in scalars.items()}
        record = {"step": int(step), "time": time.time(), **clean}
        with self._lock:
            self._jsonl.write(json.dumps(record) + "\n")
            self._jsonl.flush()
            if self._tb is not None:
                for k, v in clean.items():
                    self._tb.add_scalar(k, v, step)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class StepTimer:
    """Images/sec tracker with warmup skip.

    The window opens at the ``warmup``-th tick; with a CUDA ``device`` the
    device is synchronised there first, so the window holds the device work
    of the later steps only. Read :attr:`images_per_sec` after a
    synchronise (the trainer reads it after the logged metrics' values)."""

    def __init__(self, batch_size: int, warmup: int = 2, device=None):
        self.batch_size = batch_size
        self.warmup = warmup
        self.device = None if device is None else torch.device(device)
        self._count = 0
        self._t0 = None
        self._steps = 0

    def tick(self):
        self._count += 1
        if self._count == self.warmup:
            if self.device is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._t0 = time.perf_counter()
            self._steps = 0
        elif self._count > self.warmup:
            self._steps += 1

    @property
    def images_per_sec(self) -> Optional[float]:
        if self._t0 is None or self._steps == 0:
            return None
        return self._steps * self.batch_size / (time.perf_counter() - self._t0)


def start_trace() -> torch.profiler.profile:
    """A running ``torch.profiler`` session: host operations, and the
    device's when CUDA is available (started after a device synchronise,
    so that it holds no work queued before it)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities, record_shapes=True)
    prof.start()
    return prof


def stop_trace(prof: torch.profiler.profile, log_dir: str) -> str:
    """Stop ``prof`` (after a device synchronise) and write its Chrome
    trace to ``<log_dir>/trace.json``; returns the path."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """torch.profiler trace context (no-op when log_dir is None)."""
    if log_dir is None:
        yield
        return
    prof = start_trace()
    try:
        yield
    finally:
        stop_trace(prof, log_dir)
