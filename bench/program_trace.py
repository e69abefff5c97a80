"""Run one cell with the port's own tracer on (``repro_torch.trace``) and
print what its spans say beside the benchmark's result.

    python3 bench/program_trace.py --workload smscc-1m.ingest --seed 7 \
        --seconds 50 --trace 1 [--tracer 0]

The run is ``bench/run.py``'s (``harness.run_cell``), with the tracer
switched on before set-up; ``--tracer 0`` leaves it off, the other side
of the tracer's cost.  Around the run, and only in this process, three of
the benchmark's functions are wrapped:

- the traffic's ``counters`` also reads the service's ``host_reads``;
- with ``--trace 1``, the profiler marks a second clock anchor just
  before it stops (a ``record_function`` with ``perf_counter`` read
  inside, as the first anchor at the window's opening), and
- the trace's summary gets the program's spans, less its waits, beside
  the benchmark's own, so each idle gap is named by the innermost host
  work that left the card idle; every gap of the window is named
  (``idle_by_span``), not only the ten longest; and the window's garbage
  collections are timed, by generation and inside each of the slowest
  chunks.

Prints one JSON line, ``{"result": <the result line's object>,
"program": <what the spans say>}``, and the two anchors' offsets on
standard error.  The benchmark's own runs never run this.

Temporary: this wrapping stands in for hooks the harness lacks; it goes
once ``harness.run_cell`` switches the tracer and ``devtrace.summarize``
takes the program's spans itself (PERF.md, Open questions, item 6).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CLOSE_ANCHOR = "bench.anchor_close"


def _anchored(profiler, torch):
    """``devtrace.profiler`` whose ``stop`` first marks the close anchor:
    the marker's start on the trace's clock and ``perf_counter_ns`` read
    inside it (kept on the profiler as ``close_anchor_ns``)."""
    from torch.profiler import record_function

    def make(torch_):
        # a process's first record_function starts its event about a
        # millisecond before it returns: one before the window, so the
        # opening's anchor is read as close to its span's start as the
        # close's is
        with record_function("bench.anchor_warm"):
            pass
        prof = profiler(torch_)
        stop = prof.stop

        def stop_anchored():
            with record_function(CLOSE_ANCHOR):
                prof.close_anchor_ns = time.perf_counter_ns()
            stop()
        prof.stop = stop_anchored
        return prof
    return make


def _coverage(bench_spans, roots) -> list:
    """For each ``bench.update_chunk`` span, the share of it that the
    ``client.submit_many`` root starting inside it covers (0 if none
    lies inside it)."""
    roots = sorted((r.start_ns, r.end_ns) for r in roots)
    starts = [s for s, _ in roots]
    out = []
    for name, a, b in bench_spans:
        if name != "bench.update_chunk":
            continue
        a_ns, b_ns = int(a * 1e9), int(b * 1e9)
        i = bisect.bisect_left(starts, a_ns)
        if i < len(roots) and roots[i][1] <= b_ns:
            out.append((roots[i][1] - roots[i][0]) / max(1, b_ns - a_ns))
        else:
            out.append(0.0)
    return out


def _slowest(window, collections, n: int = 5) -> list:
    """The ``n`` slowest update chunks and the median one: self time in
    ms by span name (a row adds up to the chunk's time), and the garbage
    collections (``gc.gen<g>``) run inside the chunk."""
    from bench import spans as sp
    kids = sp.children(window)
    groups = [g for g in sp.by_trace(window).values()
              if any(s.name == "service.apply" for s in g)]
    total = {id(g): max(s.end_ns for s in g) - min(s.start_ns for s in g)
             for g in groups}
    groups.sort(key=lambda g: -total[id(g)])
    pick = groups[:n] + groups[len(groups) // 2:len(groups) // 2 + 1]
    out = []
    for g in pick:
        row = {}
        for s in g:
            row[s.name] = row.get(s.name, 0.0) + sp.self_ns(s, kids) / 1e6
        a, b = min(s.start_ns for s in g), max(s.end_ns for s in g)
        for gen, t0, t1 in collections:
            if a <= t0 and t1 <= b:
                key = f"gc.gen{gen}"
                row[key] = row.get(key, 0.0) + (t1 - t0) / 1e6
        out.append(row)
    return out


def _summarize_with_program(summarize, torch, trace, report, note,
                            collections):
    """``devtrace.summarize`` that also reads the program's spans."""
    from bench import devtrace
    from bench import spans as sp

    def wrapped(prof, torch_, bench_spans=(), anchor=0.0):
        prog, dropped = trace.take()
        trace.disable()
        a_ns = int(anchor * 1e9)
        # the window's requests: those begun from its opening on, as the
        # benchmark's chunks and requests are those begun before the
        # workers saw the close
        window = sp.in_window(prog, a_ns)
        named = [(s.name, s.start_ns / 1e9, s.end_ns / 1e9) for s in prog
                 if not s.wait]
        summary = summarize(prof, torch_, list(bench_spans) + named, anchor)

        events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                   devtrace._is_device(e, torch))
                  for e in prof.profiler.kineto_results.events()]
        (w0, w1), close, dev_iv = sp.window_events(
            events, devtrace.WINDOW_SPAN, CLOSE_ANCHOR)
        clock = sp.anchors(w0, a_ns, close, prof.close_anchor_ns)
        off_open = clock["open"]
        note(f"program_trace: the trace's clock less perf_counter: "
             f"{clock['open']} ns at the opening, {clock['close']} ns at "
             f"the close, {clock['apart'] / 1e3} us apart")
        host = [(n, int(a * 1e9) + off_open, int(b * 1e9) + off_open)
                for n, a, b in bench_spans]
        host += [(s.name, s.start_ns + off_open, s.end_ns + off_open)
                 for s in prog if not s.wait]
        # no device activity (a CPU run): no gap is the card's
        idle = sp.idle_by_span(sp.idle_gaps(dev_iv, w0, w1), host) \
            if dev_iv else {}
        idle_s = sum(idle.values())
        in_program = sum(v for k, v in idle.items()
                         if not k.startswith("bench.")
                         and k != "nothing traced")
        updates = {s.trace_id for s in window if s.name == "service.apply"}
        cover = _coverage(bench_spans, [
            s for s in window if s.name == "client.submit_many"
            and not s.parent and s.trace_id in updates])
        report.update(
            anchors_ns=clock, window_ns=(a_ns, prof.close_anchor_ns),
            spans=len(prog), dropped=dropped, window_spans=len(window),
            idle_by_span=idle, idle_s=idle_s,
            idle_in_program_share=in_program / idle_s if idle_s else None,
            idle_in_client_share=sp.share_under(idle, "client."),
            **sp.ingest_numbers(window), **sp.serve_numbers(window),
            chunk_cover_min=min(cover) if cover else None,
            chunk_cover_median=statistics.median(cover) if cover else None,
            slowest_chunks=_slowest(window, collections))
        return summary
    return wrapped


@contextlib.contextmanager
def instrumented(report: dict, note, timed_gc: bool):
    """Wrap the benchmark's functions as the module's docstring says,
    for one ``harness.run_cell``; ``report`` gets what the spans say.
    ``timed_gc`` times every garbage collection (a traced run's)."""
    import torch

    from bench import devtrace
    from bench.traffic import window
    from repro_torch import trace

    saved = (devtrace.profiler, devtrace.summarize, window.Traffic.counters)
    snaps = []
    collections, started = [], [0]

    def counters(self):  # called before the window opens and after
        snaps.append(sum(self.svc.host_reads.values()))
        return saved[2](self)

    def on_gc(phase, info):
        if phase == "start":
            started[0] = time.perf_counter_ns()
        else:
            collections.append((info["generation"], started[0],
                                time.perf_counter_ns()))

    devtrace.profiler = _anchored(saved[0], torch)
    devtrace.summarize = _summarize_with_program(saved[1], torch, trace,
                                                 report, note, collections)
    window.Traffic.counters = counters
    if timed_gc:
        gc.callbacks.append(on_gc)
    try:
        yield
    finally:
        if timed_gc:
            gc.callbacks.remove(on_gc)
        devtrace.profiler, devtrace.summarize, window.Traffic.counters = \
            saved
        if len(snaps) >= 2:
            report["host_reads"] = snaps[-1] - snaps[0]
        if "window_ns" in report:
            # the window's garbage collections, from the opening to the
            # close anchor: count, ms, longest ms
            t_open, t_close = report["window_ns"]
            by_gen: dict = {}
            for gen, t0, t1 in collections:
                if t_open <= t0 and t1 <= t_close:
                    n, tot, top = by_gen.get(f"gen{gen}", (0, 0.0, 0.0))
                    ms = (t1 - t0) / 1e6
                    by_gen[f"gen{gen}"] = (n + 1, tot + ms, max(top, ms))
            report["gc"] = by_gen


def run(cell: str, seed: int, seconds: float, trace: bool,
        tracer: bool = True, **kw) -> tuple:
    """``harness.run_cell`` of ``cell`` with the port's tracer on (or
    off); ``kw`` as ``run_cell`` takes them.  Returns ``(result,
    report)``."""
    from bench import harness
    from repro_torch import trace as tracer_mod

    note = kw.get("note") or (
        lambda msg: print(msg, file=sys.stderr, flush=True))
    report: dict = {"tracer": bool(tracer)}
    with instrumented(report, note, timed_gc=trace):
        if tracer:
            tracer_mod.enable()
        try:
            result, _ = harness.run_cell(cell, seed, seconds, trace=trace,
                                         **kw)
        finally:
            tracer_mod.disable()
            if not trace:  # the traced summary took the window's
                spans, dropped = tracer_mod.take()
                report.update(spans=len(spans), dropped=dropped)
    n = report.get("chunks")  # the window's update chunks, traced
    if n and "host_reads" in report:
        report["host_reads_per_chunk"] = report["host_reads"] / n
    return result, report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--tracer", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from bench import harness
    harness.use_checkout_caches()
    import torch

    spec = harness.load_spec()
    if not torch.cuda.is_available():
        print("program_trace: no CUDA card; nothing measured",
              file=sys.stderr)
        return 3
    result, report = run(args.workload, args.seed, args.seconds,
                         bool(args.trace), bool(args.tracer), spec=spec,
                         t_start=T_START)
    print(json.dumps({"result": result, "program": report}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
