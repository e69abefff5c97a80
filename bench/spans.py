"""Arithmetic over the port's program spans: self time, grouping by
trace id, the device's idle gaps named by the host work that left them,
and the per-layer numbers read from the spans of one window.

A program span is any object with the fields of
``repro_torch.trace.Span``: ``name``, ``start_ns``, ``end_ns``, ``id``,
``parent`` (0 for a root), ``trace_id``, ``wait`` and ``attrs``.  A span's
layer is its name up to the first dot (``client``, ``service``,
``broker``, ``query``, ``step``, ``kernels``).  This module imports
nothing of the program, so hand-built spans test it.

Temporary in part: :func:`window_events` and :func:`idle_gaps` parse the
profiler's events a second time, beside ``bench/devtrace.py``, because
the harness hands its readers no program spans yet.  They go, with
``bench/program_trace.py``, once ``devtrace.summarize`` takes the
program's spans itself (PERF.md, Open questions, item 6).
"""
from __future__ import annotations

import collections
import statistics

import numpy as np

# the spans in which the update path waits for the card
CARD_WAITS = ("service.read_back", "service.compact_check")


def layer(name: str) -> str:
    return name.split(".", 1)[0]


def children(spans) -> dict:
    """Span id -> its child spans."""
    out = collections.defaultdict(list)
    for s in spans:
        if s.parent:
            out[s.parent].append(s)
    return out


def by_trace(spans) -> dict:
    """Trace id -> the spans of that request."""
    out = collections.defaultdict(list)
    for s in spans:
        out[s.trace_id].append(s)
    return out


def covered_ns(a: int, b: int, intervals) -> int:
    """How much of ``[a, b)`` the union of ``intervals`` covers."""
    total, end = 0, a
    for s, t in sorted(intervals):
        s, t = max(s, end), min(t, b)
        if t > s:
            total += t - s
            end = t
    return total


def self_ns(span, kids: dict) -> int:
    """The span's duration less the part its children cover."""
    return span.end_ns - span.start_ns - covered_ns(
        span.start_ns, span.end_ns,
        [(c.start_ns, c.end_ns) for c in kids.get(span.id, ())])


def layer_ns(span, kids: dict) -> int:
    """Time in the span's own layer: its duration less the part covered
    by the outermost descendants of other layers."""
    own, other, todo = layer(span.name), [], list(kids.get(span.id, ()))
    while todo:
        c = todo.pop()
        if layer(c.name) == own:
            todo.extend(kids.get(c.id, ()))
        else:
            other.append((c.start_ns, c.end_ns))
    return span.end_ns - span.start_ns - covered_ns(span.start_ns,
                                                    span.end_ns, other)


def descendants(span, kids: dict) -> list:
    out, todo = [], list(kids.get(span.id, ()))
    while todo:
        c = todo.pop()
        out.append(c)
        todo.extend(kids.get(c.id, ()))
    return out


def _waits_ns(span, kids, names=None) -> int:
    iv = [(d.start_ns, d.end_ns) for d in descendants(span, kids)
          if d.wait and (names is None or d.name in names)]
    return covered_ns(span.start_ns, span.end_ns, iv)


def in_window(spans, t0_ns: int, t1_ns: int | None = None) -> list:
    """The spans of the requests whose root started in ``[t0, t1)``
    (from ``t0`` on where ``t1`` is None)."""
    roots = {s.trace_id for s in spans if not s.parent and t0_ns
             <= s.start_ns and (t1_ns is None or s.start_ns < t1_ns)}
    return [s for s in spans if s.trace_id in roots]


def chunk_numbers(spans) -> list:
    """Per update chunk (a request with a ``service.apply`` span), in ms:
    ``client`` the root's client-layer time, ``service_host``
    ``service.apply`` less its waits, ``card_wait`` the summed
    ``service.read_back`` and ``service.compact_check``, ``lock_wait``,
    and ``total`` the root's duration."""
    kids = children(spans)
    rows = []
    for group in by_trace(spans).values():
        roots = [s for s in group if s.name == "client.submit_many"
                 and not s.parent]
        applies = [s for s in group if s.name == "service.apply"]
        if len(roots) != 1 or not applies:
            continue
        root = roots[0]
        host = sum(a.end_ns - a.start_ns - _waits_ns(a, kids)
                   for a in applies)
        card = sum(_waits_ns(a, kids, CARD_WAITS) for a in applies)
        lock = sum(_waits_ns(a, kids, ("service.lock_wait",))
                   for a in applies)
        rows.append({"client": layer_ns(root, kids) / 1e6,
                     "service_host": host / 1e6, "card_wait": card / 1e6,
                     "lock_wait": lock / 1e6,
                     "total": (root.end_ns - root.start_ns) / 1e6})
    return rows


def _median(xs):
    return statistics.median(xs) if xs else None


def ingest_numbers(spans) -> dict:
    """The medians over the chunks of :func:`chunk_numbers`:
    ``client_self_ms``, ``service_host_ms``, ``card_wait_ms``,
    ``lock_wait_ms`` and ``submit_ms``, and the chunks' count."""
    rows = chunk_numbers(spans)

    def med(key):
        return _median([r[key] for r in rows])
    return {"client_self_ms": med("client"),
            "service_host_ms": med("service_host"),
            "card_wait_ms": med("card_wait"),
            "lock_wait_ms": med("lock_wait"),
            "submit_ms": med("total"), "chunks": len(rows)}


def serve_numbers(spans) -> dict:
    """``queue_wait_ms``: the 95th percentile of ``broker.queued``;
    ``flush_host_ms``: the median ``broker.flush`` less its
    ``query.read_back``."""
    kids = children(spans)
    queued = [(s.end_ns - s.start_ns) / 1e6 for s in spans
              if s.name == "broker.queued"]
    flush = [(s.end_ns - s.start_ns
              - _waits_ns(s, kids, ("query.read_back",))) / 1e6
             for s in spans if s.name == "broker.flush"]
    return {"queue_wait_ms": float(np.percentile(queued, 95))
            if queued else None,
            "flush_host_ms": _median(flush), "requests": len(queued),
            "flushes": len(flush)}


# ------------------------------------------- the device's idle gaps ---

def window_events(events, window: str, close_mark: str) -> tuple:
    """From ``(name, start_ns, end_ns, on_device)`` events: the window
    span's ``(start, end)``, the close marker's start (None if absent) and
    the device's ``(start, end)`` intervals."""
    win = close = None
    dev = []
    for name, s, e, on_device in events:
        if on_device:
            dev.append((s, e))
        elif name == window:
            win = (s, e)
        elif name == close_mark:
            close = s
    return win, close, dev


def anchors(w0: int, open_ns: int, close_mark: int, close_ns: int) -> dict:
    """The trace's clock less ``perf_counter_ns`` at the window's opening
    (its span's start against the anchor read just inside it) and at the
    close marker, and how far the two lie apart, in ns."""
    a, b = w0 - open_ns, close_mark - close_ns
    return {"open": a, "close": b, "apart": b - a}


def idle_gaps(device_iv, w0: int, w1: int) -> list:
    """The ``(start, end)`` gaps of ``[w0, w1)`` in which no interval of
    ``device_iv`` runs."""
    merged = []
    for s, t in sorted((max(s, w0), min(t, w1)) for s, t in device_iv
                       if t > w0 and s < w1):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def idle_by_span(gaps, host_spans) -> dict:
    """Device-idle seconds by the name of the host work that left each
    gap, over every gap, each named by ``devtrace``'s rule for the traced
    window's longest gaps (``devtrace._host_activity``).  ``gaps`` are
    sorted disjoint ``(start, end)`` and ``host_spans`` ``(name, start,
    end)``, on one clock.  One sweep keeps the spans that can overlap the
    gap at hand, so the rule sees a few spans a gap, not every span of
    the window."""
    from bench import devtrace
    names = [n for n, _, _ in host_spans]
    cs = np.asarray([x[1] for x in host_spans], np.int64)
    ce = np.asarray([x[2] for x in host_spans], np.int64)
    order = np.argsort(cs, kind="stable").tolist()
    active, i = [], 0
    out = collections.Counter()
    for a, b in gaps:
        while i < len(order) and cs[order[i]] < b:
            active.append(order[i])
            i += 1
        active = [j for j in active if ce[j] > a]
        # in the spans' own order, so ties fall as over all of them
        pick = np.asarray(sorted(active), np.int64)
        name = devtrace._host_activity(cs[pick], ce[pick],
                                       [names[j] for j in pick], a, b)
        out[name] += (b - a) / 1e9
    return dict(out.most_common())


def share_under(idle: dict, prefix: str) -> float | None:
    """The share of the idle seconds in ``idle`` named by a span whose
    name starts with ``prefix``."""
    total = sum(idle.values())
    if total <= 0:
        return None
    return sum(v for k, v in idle.items() if k.startswith(prefix)) / total
