"""The traced window: ``torch.profiler`` over the run's measured window,
reduced to what the per-layer readers and the result line need.

- ``busy_s``: the seconds in which an operation (kernel, copy or fill) ran
  on the card, the union of their intervals inside the window;
- ``window_s``: the length of the window (the ``bench.window`` span);
- ``ops``: device seconds and count by operation name;
- ``breakdown``: the ten operations that took the most device time, and
  the ten longest idle gaps, each named by what the host was doing then:
  the benchmark's own span (a session's update chunk, a reader's request)
  that covers at least half the gap, else the one that overlaps it most.

The profiler records the card's activity and the host ops of the thread
that starts it alone: recording every op of the sessions' and the broker's
threads slowed their host path by a third and more, which pushed the
traced serving window past the rate it sustains (PERF.md).  The
benchmark's spans are kept by the harness on the host's clock and laid on
the trace's from the window's opening.  The raw events are read from the
profiler's results directly, without its per-event Python tree, so a
window of millions of events reduces in seconds.
"""
from __future__ import annotations

import collections

import numpy as np

WINDOW_SPAN = "bench.window"
TOP = 10


def profiler(torch):
    """A profiler of the card and of the calling thread's host ops."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _is_device(e, torch) -> bool:
    if e.device_type() != torch.autograd.DeviceType.CUDA:
        return False
    kind = getattr(e, "activity_type", lambda: "")()
    return "annotation" not in str(kind) and not e.name().startswith(
        "bench.")


def summarize(prof, torch, spans=(), anchor: float = 0.0) -> dict:
    """The window's summary; ``spans`` are the benchmark's host spans,
    ``(name, start, end)`` in seconds of the clock on which the window
    opened at ``anchor``."""
    events = prof.profiler.kineto_results.events()
    win = [e for e in events if e.name() == WINDOW_SPAN
           and e.device_type() == torch.autograd.DeviceType.CPU]
    if not win:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    w0 = win[0].start_ns()
    w1 = w0 + win[0].duration_ns()
    dev_iv, by_name = [], collections.defaultdict(lambda: [0, 0.0])
    cpu_s = [w0 + int((a - anchor) * 1e9) for _, a, _ in spans]
    cpu_e = [w0 + int((b - anchor) * 1e9) for _, _, b in spans]
    cpu_n = [name for name, _, _ in spans]
    for e in events:
        s = e.start_ns()
        t = s + e.duration_ns()
        if t <= w0 or s >= w1:
            continue
        if _is_device(e, torch):
            s, t = max(s, w0), min(t, w1)
            dev_iv.append((s, t))
            rec = by_name[e.name()]
            rec[0] += 1
            rec[1] += (t - s) / 1e9
    merged = []
    for s, t in sorted(dev_iv):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged) / 1e9
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[i + 1] - edges[i], edges[i], edges[i + 1])
            for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps.sort(reverse=True)
    cs, ce = np.asarray(cpu_s, np.int64), np.asarray(cpu_e, np.int64)
    idle = [[_host_activity(cs, ce, cpu_n, a, b), n / 1e9]
            for n, a, b in gaps[:TOP]]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return {"busy_s": busy, "window_s": (w1 - w0) / 1e9,
            "ops": {k: (c, s) for k, (c, s) in by_name.items()},
            "breakdown": {"device_ops": [[k[:120], v[1]]
                                         for k, v in ops[:TOP]],
                          "idle_gaps": idle}}


def _host_activity(cs, ce, names, a: int, b: int) -> str:
    if cs.size == 0:
        return "nothing traced"
    over = np.minimum(ce, b) - np.maximum(cs, a)
    hit = np.nonzero(over > 0)[0]
    if hit.size == 0:
        return "nothing traced"
    half = hit[over[hit] * 2 >= (b - a)]
    if half.size:
        pick = half[np.argmin(ce[half] - cs[half])]
    else:
        pick = hit[np.argmax(over[hit])]
    return names[pick][:120]
