"""One window of work under ``torch.profiler``, its device time summed by
kernel family: the breakdown the ``profile_*_torch.py`` scripts print.

Each script passes its own family table: (family, substrings) pairs, the
first family whose substring is in a kernel's lower-cased name wins,
"other_elementwise" if none is.
"""
from __future__ import annotations

import collections
import re
import time


def family(name: str, families) -> str:
    low = name.lower()
    for fam, keys in families:
        if any(k in low for k in keys):
            return fam
    return "other_elementwise"


# the runtime calls by which the host puts work on the card: kernel
# launches, graph replays, copies and fills
HOST_ISSUE = re.compile(r"^cu(da)?(Launch|GraphLaunch|Memcpy|Memset)")


def profiled(torch, fn, families, top: int = 10) -> dict:
    """Run ``fn`` once under the profiler: its wall seconds (host clock to
    a synchronise), the device's busy seconds (the sum of the kernels'
    device times; one stream, so they do not overlap) and idle share, the
    kernels launched, the host's calls that issue work (``HOST_ISSUE``,
    by name: a graph replay is one), the device seconds of each family and
    the ``top`` costliest kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    issued = collections.Counter(
        e.name for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CPU
        and HOST_ISSUE.match(e.name))
    by_fam = collections.Counter()
    by_name = collections.Counter()
    for e in kernels:
        us = e.device_time_total
        by_fam[family(e.name, families)] += us
        by_name[e.name] += us
    busy = sum(by_fam.values()) / 1e6
    return {"wall_s": wall, "device_busy_s": busy,
            "device_idle_share": 1.0 - busy / wall if wall else None,
            "kernels": len(kernels),
            "host_issue_calls": dict(issued.most_common()),
            "device_s_by_family": {k: v / 1e6
                                   for k, v in by_fam.most_common()},
            "top_kernels_s": [[n[:120], v / 1e6]
                              for n, v in by_name.most_common(top)]}
