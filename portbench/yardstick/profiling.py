"""The device trace of a traced run: ``torch.profiler`` on the CUDA
timeline, reduced over a span of the window to the device's busy
seconds, each kernel's device time, the top device operations and the
longest idle gaps by what the host was doing.

Starting the profiler initialises CUPTI and stopping it gathers the
events, each of them seconds: done inside the window they stall the
program and the traced run's spans read the stall. So the profiler is
``arm``ed in set-up, runs through the window, and is ``finish``ed after
it; ``mark()`` puts a tiny marker kernel (``torch.cuda._sleep``) on the
device at the span's start and end, after a sync, and notes the host's
``time.perf_counter`` there. The span is the device time between the
two markers; the marker's start against its host time gives the offset
between the two clocks.

Device work is every event the profiler puts on the CUDA timeline
(kernels, copies, sets) but the markers; busy time is the union of their
intervals inside the span. A gap with no device work is named by the
innermost host span (``track name``, on the perf_counter clock) running
at its middle, or ``host outside the spans``.
"""
from __future__ import annotations

import time
from collections import defaultdict

MARKER = "spin_kernel"
MARKER_CYCLES = 1000


def _start_end_ns(ev) -> tuple[int, int]:
    try:
        s = ev.start_ns()
        return s, s + ev.duration_ns()
    except AttributeError:          # an older torch: microseconds
        s = int(ev.start_us() * 1000)
        return s, s + int(ev.duration_us() * 1000)


class DeviceTrace:
    """``arm()`` in set-up, ``mark()`` at the span's start and end inside
    the window, ``finish()`` after it, then ``reduce(spans)``. ``t0``/
    ``t1`` are the span's ends on the host's perf_counter clock."""

    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = None
        self.result = None

    @property
    def active(self) -> bool:
        return self.t0 is not None and self.t1 is None

    def arm(self) -> None:
        import torch

        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.start()

    def mark(self) -> None:
        import torch

        torch.cuda.synchronize()
        t = time.perf_counter()
        torch.cuda._sleep(MARKER_CYCLES)
        if self.t0 is None:
            self.t0 = t
        else:
            self.t1 = t

    def finish(self) -> None:
        if self.active:
            self.mark()
        self.prof.stop()

    def reduce(self, spans=(), top: int = 10) -> dict:
        """{busy_s, window_s, kernel_s: {name: s}, device_ops, idle_gaps}
        over the span (the last two: at most ``top`` [name, seconds])."""
        import torch

        dev, marks = [], []
        for ev in self.prof.profiler.kineto_results.events():
            if ev.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            s, e = _start_end_ns(ev)
            if e <= s:
                continue
            if MARKER in ev.name():
                marks.append((s, e))
            else:
                dev.append((s, e, ev.name()))
        self.prof = None            # the events are no longer needed
        marks.sort()
        if len(marks) < 2:
            raise RuntimeError(f"the device trace holds {len(marks)} span "
                               f"markers ({MARKER}), not 2")
        lo, hi = marks[0][1], marks[-1][0]
        offset = marks[0][0] * 1e-9 - self.t0     # device minus host, s
        kernel_s: dict[str, float] = defaultdict(float)
        iv = []
        for s, e, name in dev:
            s, e = max(s, lo), min(e, hi)
            if e > s:
                iv.append((s, e))
                kernel_s[name] += (e - s) * 1e-9
        busy_ns, gaps = _union_and_gaps(iv, lo, hi)
        host = [(sp["start"] + offset, sp["end"] + offset,
                 f"{sp['track']} {sp['name']}") for sp in spans]
        by_host = _label_gaps(gaps, host)
        ops = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        self.result = {"busy_s": busy_ns * 1e-9,
                       "window_s": (hi - lo) * 1e-9,
                       "kernel_s": dict(kernel_s),
                       "device_ops": [[n, s] for n, s in ops],
                       "idle_gaps": [[n, s] for n, s in idle]}
        return self.result


def _union_and_gaps(iv, lo: int, hi: int) -> tuple[int, list]:
    """Busy nanoseconds of the intervals ``iv`` inside [lo, hi] and the
    idle gaps between them there."""
    busy, gaps, cur_s, cur_e = 0, [], None, lo
    for s, e in sorted(iv):
        if cur_s is None or s > cur_e:
            if cur_s is not None:
                busy += cur_e - cur_s
            if s > cur_e:
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_s is not None:
        busy += cur_e - cur_s
    if hi > cur_e:
        gaps.append((cur_e, hi))
    return busy, gaps


def _label_gaps(gaps, host, labelled: int = 2000) -> dict:
    """Idle seconds by the innermost (shortest) host span running at each
    gap's middle (``host`` holds (start s, end s, name) on the device's
    clock), ``host outside the spans`` where none runs. The ``labelled``
    longest gaps are named; the rest are summed as ``short gaps``."""
    import numpy as np

    out: dict[str, float] = defaultdict(float)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])
    if host:
        starts = np.array([s for s, _, _ in host])
        ends = np.array([e for _, e, _ in host])
        lens = ends - starts
    for lo, hi in gaps[:labelled]:
        name = "host outside the spans"
        if host:
            t = (lo + hi) * 0.5e-9
            cover = np.where((starts <= t) & (ends > t), lens, np.inf)
            i = int(np.argmin(cover))
            if np.isfinite(cover[i]):
                name = host[i][2]
        out[name] += (hi - lo) * 1e-9
    rest = sum(hi - lo for lo, hi in gaps[labelled:])
    if rest:
        out["short gaps"] += rest * 1e-9
    return out
