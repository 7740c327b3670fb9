"""The traced stretch: ``torch.profiler`` over a few calls, reduced to
the device's busy time, its operations by time, the idle gaps by what
the host was doing, and the device time of named kernels.

Busy time is the union of every device activity's interval (kernels,
copies, sets, on any stream) inside the window, which a
``record_function`` span of the benchmark marks in the profiler's own
clock; the window is that span's length. An idle gap is a stretch of the
window with nothing on the device; it is put down to the innermost host
event that covers its midpoint.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

WINDOW = "benchmark.traced_window"
TOP = 10
NAME_CHARS = 120


def merge(intervals: Sequence[Tuple[float, float]]) -> List[List[float]]:
    """The union of ``(start, end)`` intervals, as sorted disjoint ones."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def gaps(busy: Sequence[Sequence[float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval of ``busy`` (merged)
    covers."""
    out, at = [], lo
    for s, e in busy:
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


def idle_share(busy_s: float, window_s: float) -> float:
    """Per cent of the window with nothing on the device."""
    return 100.0 * (1.0 - busy_s / window_s)


@dataclass
class Summary:
    """The traced window, in seconds."""

    window_s: float
    busy_s: float
    device_ops: List[Tuple[str, float]]  # by name, most time first
    idle_gaps: List[Tuple[str, float]]  # by host event, most time first
    kernels: List[Tuple[str, float]]  # (name, seconds), every activity

    def kernel_s(self, name: str) -> float:
        """Device seconds of the kernels whose symbol is ``name``."""
        pat = re.compile(rf"(^|\W){re.escape(name)}(\W|$)")
        return sum(s for n, s in self.kernels if pat.search(n))

    def breakdown(self) -> Dict:
        return {"device_ops": [[n, s] for n, s in self.device_ops[:TOP]],
                "idle_gaps": [[n, s] for n, s in self.idle_gaps[:TOP]]}


def summarize(device: Sequence[Tuple[str, float, float]],
              host: Sequence[Tuple[str, float, float]],
              window: Tuple[float, float], top_gaps: int = 256) -> Summary:
    """Reduce a trace: ``device`` and ``host`` are (name, start, end) in
    one clock (seconds), ``window`` the traced stretch. The ``top_gaps``
    longest gaps are put down to host events."""
    lo, hi = window
    inside = [(n, max(s, lo), min(e, hi)) for n, s, e in device
              if min(e, hi) > max(s, lo)]
    busy = merge([(s, e) for _, s, e in inside])
    busy_s = sum(e - s for s, e in busy)
    by_op: Dict[str, float] = {}
    for n, s, e in inside:
        by_op[n[:NAME_CHARS]] = by_op.get(n[:NAME_CHARS], 0.0) + (e - s)
    idle = sorted(gaps(busy, lo, hi), key=lambda g: g[0] - g[1])[:top_gaps]
    by_host: Dict[str, float] = {}
    if host and idle:
        names = [n for n, _, _ in host]
        hs = np.array([s for _, s, _ in host])
        he = np.array([e for _, _, e in host])
        length = he - hs
        for s, e in idle:
            mid = 0.5 * (s + e)
            cover = np.flatnonzero((hs <= mid) & (he >= mid))
            name = ("host: no event" if not len(cover) else
                    names[cover[np.argmin(length[cover])]])
            key = name[:NAME_CHARS]
            by_host[key] = by_host.get(key, 0.0) + (e - s)
    return Summary(
        window_s=hi - lo, busy_s=busy_s,
        device_ops=sorted(by_op.items(), key=lambda kv: -kv[1]),
        idle_gaps=sorted(by_host.items(), key=lambda kv: -kv[1]),
        kernels=[(n, e - s) for n, s, e in inside])


def profile(fn: Callable[[], None], sync: Callable[[], None],
            chrome: Optional[Path] = None) -> Summary:
    """Run ``fn`` once under ``torch.profiler`` (host and CUDA) between
    two synchronisations, and summarise it. ``chrome`` names a file for
    the Chrome trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    sync()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(WINDOW):
            fn()
            sync()
    if chrome is not None:
        chrome.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(chrome))
    device, host, window = [], [], None
    for ev in prof.events():
        s, e = ev.time_range.start * 1e-6, ev.time_range.end * 1e-6
        if ev.device_type == DeviceType.CUDA:
            # A span's device-side copy (a GPU user annotation) is no
            # activity: the window's covers the whole window.
            if ev.name != WINDOW and not getattr(ev, "is_user_annotation",
                                                 False):
                device.append((ev.name, s, e))
        elif ev.name == WINDOW:
            window = (s, e)
        else:
            host.append((ev.name, s, e))
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    if not device:
        raise RuntimeError("the profiler recorded no device activity: "
                           "CUPTI tracing is not working on this machine")
    return summarize(device, host, window)
