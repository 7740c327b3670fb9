"""The program's spans in the traced run's Chrome trace, and what the
device did under them.

The program names stretches of its own work with ``record_function``
ranges called ``eegan.<name>`` (``eegan_tpu_torch/training/logging.py:
span``), in the profiler's clock beside its operations. In the window
(the ``benchmark.traced_window`` range):

- a device activity (kernel, copy or set) belongs to the spans whose host
  interval holds the CUDA runtime or driver API call that launched it
  (linked by the trace's ``correlation`` id), on any thread: autograd's
  thread launches the backward's kernels while the main thread waits in
  ``backward()`` inside a phase span. The innermost of them is its span;
  one under no span is outside the program's spans;
- an activity whose launch the trace lacks takes the spans of its
  neighbours on its stream when the previous and the next activity with a
  launch share their innermost span (or both lie outside every span);
  otherwise it stays unattributed;
- the busy time under a set of spans is the union of the intervals of the
  activities under any of them;
- every idle stretch of the window (nothing on any stream) is put down to
  the spans that cover its midpoint, as ``trace.summarize`` does.

Spans are selected by name: ``train.d_hinge`` selects
``eegan.train.d_hinge`` and ``eegan.train.d_hinge.<scale>``.

    python3 -m benchmark.spans benchmark_out/<cell>-<seed>.trace.json

prints each span name's busy and idle seconds and the unattributed share.
"""

from __future__ import annotations

import functools
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from benchmark.trace import WINDOW, gaps, merge

PREFIX = "eegan."
ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCHES = ("cuda_runtime", "cuda_driver")
OUTSIDE, UNATTRIBUTED = -1, -2  # an activity's span when it has none
CHUNK = 8192  # activities tested against the spans at once
NCCL = re.compile(r"(^|\W)nccl\w*Kernel")  # an NCCL kernel's symbol


@dataclass
class Spans:
    """The window's spans and activities, in seconds."""

    names: List[str]  # each span's name, without the prefix
    starts: np.ndarray  # each span's host interval
    ends: np.ndarray
    acts: np.ndarray  # (n, 2) activity intervals, clipped to the window
    launch: np.ndarray  # each activity's launch time (a neighbour's for
    # one whose launch the trace lacks; NaN when unattributed)
    inner: np.ndarray  # each activity's innermost span, OUTSIDE or
    # UNATTRIBUTED
    idle: List[tuple]  # the window's idle stretches
    window_s: float
    labels: List[str]  # each activity's name

    def selected(self, names: Sequence[str]) -> np.ndarray:
        """Which spans ``names`` select (a name, or a name and a dot)."""
        return np.array([any(n == s or n.startswith(s + ".") for s in names)
                         for n in self.names], dtype=bool)

    def has(self, names: Sequence[str]) -> bool:
        return bool(self.selected(names).any())

    def busy_s(self, names: Sequence[str]) -> float:
        """Device-busy seconds of the activities under the spans
        ``names`` select."""
        sel = self.selected(names)
        under = innermost(self.launch, self.starts[sel], self.ends[sel])
        return union_s(self.acts[under != OUTSIDE])

    def idle_s(self, names: Sequence[str]) -> float:
        """Idle seconds of the stretches whose midpoint lies under the
        spans ``names`` select."""
        if not self.idle:
            return 0.0
        sel = self.selected(names)
        stretches = np.array(self.idle)
        under = innermost(stretches.mean(axis=1), self.starts[sel],
                          self.ends[sel]) != OUTSIDE
        return float((stretches[under, 1] - stretches[under, 0]).sum())

    @property
    def total_busy_s(self) -> float:
        return union_s(self.acts)

    def share(self, which: int) -> float:
        """Per cent of the window's busy time of activities that are
        OUTSIDE every span or UNATTRIBUTED."""
        busy = self.total_busy_s
        return 100.0 * union_s(self.acts[self.inner == which]) / busy \
            if busy > 0 else 0.0

    def by_span(self) -> Dict[str, Dict[str, float]]:
        """Busy and idle seconds under each span name (the span and its
        children; idle by its midpoint), innermost busy alone too."""
        out = {}
        for name in sorted(set(self.names)):
            own = np.array([n == name for n in self.names])
            out[name] = dict(
                busy_s=self.busy_s([name]), idle_s=self.idle_s([name]),
                own_busy_s=union_s(self.acts[np.isin(
                    self.inner, np.flatnonzero(own))]))
        return out


def innermost(t: np.ndarray, starts: np.ndarray, ends: np.ndarray
              ) -> np.ndarray:
    """The index of the shortest interval [start, end] that holds each time
    ``t``, or OUTSIDE (so for a NaN time)."""
    out = np.full(len(t), OUTSIDE, dtype=np.int64)
    if not len(starts):
        return out
    length = ends - starts
    for a in range(0, len(t), CHUNK):
        c = t[a:a + CHUNK, None]
        hold = (starts[None] <= c) & (c <= ends[None])
        pick = np.where(hold, length[None], np.inf).argmin(1)
        out[a:a + CHUNK] = np.where(hold.any(1), pick, OUTSIDE)
    return out


def union_s(intervals: np.ndarray) -> float:
    return float(sum(e - s for s, e in merge(map(tuple, intervals))))


def overlap_s(a: np.ndarray, b: np.ndarray) -> float:
    """Seconds that the union of intervals ``a`` and the union of ``b``
    share."""
    ua, ub = merge(map(tuple, a)), merge(map(tuple, b))
    out, j = 0.0, 0
    for s, e in ua:
        while j < len(ub) and ub[j][1] <= s:
            j += 1
        k = j
        while k < len(ub) and ub[k][0] < e:
            out += min(e, ub[k][1]) - max(s, ub[k][0])
            k += 1
    return out


def nccl(s: "Spans") -> np.ndarray:
    """Which activities are NCCL kernels, by symbol."""
    return np.array([NCCL.search(n) is not None for n in s.labels],
                    dtype=bool)


def from_events(events: Sequence[Dict]) -> Optional["Spans"]:
    """:class:`Spans` of a Chrome trace's ``traceEvents``; None without the
    window or without a span of the program."""
    window = None
    spans, launches, acts = [], {}, []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat"), ev.get("name", "")
        s = 1e-6 * float(ev["ts"])
        e = s + 1e-6 * float(ev.get("dur", 0.0))
        if cat == "user_annotation":
            if name == WINDOW:
                window = (s, e)
            elif name.startswith(PREFIX):
                spans.append((name[len(PREFIX):], s, e))
        elif cat in LAUNCHES:
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = min(s, launches.get(corr, s))
        elif cat in ACTIVITIES:
            acts.append((s, e, ev.get("args", {}).get("correlation"),
                         (ev.get("pid"), ev.get("tid")), name))
    if window is None or not spans:
        return None
    lo, hi = window
    acts = [(max(s, lo), min(e, hi), c, q, n) for s, e, c, q, n in acts
            if min(e, hi) > max(s, lo)]
    names = [n for n, _, _ in spans]
    starts = np.array([s for _, s, _ in spans])
    ends = np.array([e for _, _, e in spans])
    launch = np.array([launches.get(a[2], np.nan) for a in acts],
                      dtype=float)
    inner = innermost(launch, starts, ends)
    inner[np.isnan(launch)] = UNATTRIBUTED
    _from_neighbours(acts, launch, inner)
    intervals = [(a[0], a[1]) for a in acts]
    return Spans(names=names, starts=starts, ends=ends,
                 acts=np.array(intervals, dtype=float).reshape(-1, 2),
                 launch=launch, inner=inner,
                 idle=gaps(merge(intervals), lo, hi), window_s=hi - lo,
                 labels=[a[4] for a in acts])


def _from_neighbours(acts, launch: np.ndarray, inner: np.ndarray) -> None:
    """An activity without a launch takes the launch time (so the spans)
    of the previous activity on its stream that has one, when the next one
    that has one shares its innermost span."""
    streams: Dict = {}
    for i, a in enumerate(acts):
        streams.setdefault(a[3], []).append((a[0], i))
    for order in streams.values():
        order = [i for _, i in sorted(order)]
        known = [i for i in order if not np.isnan(launch[i])]
        if not known:
            continue
        pos = {i: k for k, i in enumerate(order)}
        known_pos = np.array([pos[i] for i in known])
        for k, i in enumerate(order):
            if not np.isnan(launch[i]):
                continue
            j = np.searchsorted(known_pos, k)
            if j == 0 or j == len(known):
                continue
            prev, nxt = known[j - 1], known[j]
            if inner[prev] == inner[nxt]:
                launch[i], inner[i] = launch[prev], inner[prev]


@functools.lru_cache(maxsize=1)
def _load(path: str, stamp: tuple) -> Optional[Spans]:
    with open(path) as f:
        return from_events(json.load(f).get("traceEvents", []))


def load(path: Path) -> Optional[Spans]:
    """The spans of the Chrome trace at ``path`` (parsed once while the
    file stays as it is); None without the file, the window or a span."""
    try:
        st = path.stat()
    except FileNotFoundError:
        return None
    return _load(str(path), (st.st_mtime_ns, st.st_size))


def trace_file(cell) -> Path:
    """The Chrome trace of this run's traced stretch, by the cell and the
    seed of this process's own arguments."""
    from benchmark.run import OUT_DIR, parse_args

    seed = parse_args(sys.argv[1:]).seed
    return cell.root / OUT_DIR / f"{cell.name}-{seed}.trace.json"


def of_run(obs, kind: str) -> Optional[Spans]:
    """The spans of a traced run of traffic ``kind``, for a reader; None
    for another kind, an untraced run or a program without spans."""
    if obs.get("kind") != kind or obs.get("trace") is None:
        return None
    return load(trace_file(obs["cell"]))


def main(argv=None) -> int:
    for path in (argv if argv is not None else sys.argv[1:]):
        s = load(Path(path))
        if s is None:
            print(f"{path}: no window or no span of the program")
            continue
        print(f"{path}: window {s.window_s:.6f} s, busy "
              f"{s.total_busy_s:.6f} s, idle "
              f"{sum(e - b for b, e in s.idle):.6f} s, outside the spans "
              f"{s.share(OUTSIDE):.3f}% of busy, unattributed "
              f"{s.share(UNATTRIBUTED):.3f}% of busy "
              f"({int((s.inner == UNATTRIBUTED).sum())} of {len(s.inner)} "
              "activities)")
        for name, v in s.by_span().items():
            print(f"  {name}: busy {v['busy_s']:.6f} s (own "
                  f"{v['own_busy_s']:.6f}), idle {v['idle_s']:.6f} s")
        for which, label in ((UNATTRIBUTED, "unattributed"),
                             (OUTSIDE, "outside the spans")):
            by: Dict[str, float] = {}
            for i in np.flatnonzero(s.inner == which):
                key = s.labels[i][:80]
                by[key] = by.get(key, 0.0) + s.acts[i, 1] - s.acts[i, 0]
            for key, sec in sorted(by.items(), key=lambda kv: -kv[1])[:8]:
                print(f"  {label}: {sec:.6f} s {key}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
