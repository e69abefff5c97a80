"""One run of one benchmark cell: set-up, the measured window, the check
against the plain reference, and the result line.

Everything a cell needs is found by name, so that a later cell, mix,
configuration or metric is a new file and a new entry in
``BENCHMARK.json``, with no file here edited:

- ``BENCHMARK.json`` names the cell's configuration, traffic mix and
  metrics;
- ``bench/configs/<config>.json`` holds the deployment: its shapes, engine
  settings and guarantees;
- ``bench/traffic/<mix>.json`` holds the mix's parameters, among them
  ``generator``, the name of the module ``bench/traffic/<generator>.py``
  that reads them;
- ``bench/metrics/<metric>.py`` holds each metric's reader,
  ``read(run) -> float | None`` over a :class:`Run`.

A generator module gives ``check_mix(mix) -> mix`` and ``Traffic(config,
mix, seed, device, note)``, whose making is the cell's set-up and
warm-up.  A ``Traffic`` gives ``workers(clock)``, the bodies of the
threads that drive the system in the window; ``sync()``, which waits for
the device; ``counters()``, the program's counters; ``finish()``, which
takes the program's outputs and frees its state; ``check(note)``, the
compared numbers, each ``(value, limit)``; ``chunks`` and ``requests``,
the window's update chunks and query requests (:class:`Chunk`,
:class:`Request`); ``sizes``, the cell's logical sizes for the byte
counts; and ``describe()``, a line for standard error.

The window opens when every worker is released and closes ``seconds``
later.  The harness waits for the work still under way at the close, reads
the peak memory, has the traffic take its outputs and free the program's
state, and only then runs the check.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import sys
import threading
import time
import traceback
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
JOIN_S = 60.0  # how long past the close the window's last work may take
# every cache a run may write stays at a fixed path inside the checkout
# (the kernels' own build directory, build/repro_torch_kernels, is fixed
# by the program)
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda"}


def use_checkout_caches() -> None:
    """Point the caches of torch, Triton and the CUDA driver into the
    checkout (call before the card is first used)."""
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)


# ------------------------------------------------ what is found by name ---

def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_of(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_of(spec: dict, name: str, root: Path = ROOT) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def generator_of(name: str):
    """The module ``bench/traffic/<name>.py``."""
    if not name.isidentifier():
        raise ValueError(f"generator {name!r} is not a module name")
    return importlib.import_module(f"bench.traffic.{name}")


def mix_of(name: str) -> dict:
    """The mix ``bench/traffic/<name>.json``, checked by its generator."""
    mix = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    return generator_of(mix["generator"]).check_mix(mix)


def metrics_of(spec: dict, cell: str, trace: bool) -> list:
    """The cell's metric entries: its per-layer ones with ``trace``, else
    its end-to-end ones (an entry without ``workloads`` is every cell's)."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def reader_of(metric: str) -> Callable:
    path = BENCH / "metrics" / f"{metric}.py"
    mod_name = "bench_metric_" + "".join(
        c if c.isalnum() else "_" for c in metric)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the port must not load."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


# -------------------------------------------------------- what is read ---

@dataclasses.dataclass
class Chunk:
    """One update chunk a session submitted and the acks it got."""
    session: int
    j: int  # window index; -1 for set-up's
    arrays: tuple  # (kind, u, v) int32
    t_submit: float
    t_ack: Optional[float] = None
    gen: Optional[int] = None
    ok: Optional[np.ndarray] = None
    late_s: float = 0.0

    @property
    def n_ops(self) -> int:
        return int(self.arrays[0].shape[0])


@dataclasses.dataclass
class Request:
    """One request of queries and its answers.  ``t_submit`` is when its
    user sent it: its arrival where arrivals are scheduled, even if every
    reader was busy then."""
    reader: int  # -1 for set-up's
    u: np.ndarray
    v: np.ndarray
    t_submit: float
    t_ack: Optional[float] = None
    gen: Optional[int] = None
    values: Optional[list] = None


@dataclasses.dataclass
class Run:
    """What the metric readers read.  Times are host seconds
    (``time.perf_counter``); ``chunks`` and ``requests`` hold the
    window's, ``counters`` the program's counters over the window (empty
    where they are not kept: on the CPU), ``trace`` the traced window's
    summary (:mod:`bench.devtrace`) or None."""
    cell: str
    config: dict
    mix: dict
    seconds: float
    setup_s: float
    t_open: float
    t_close: float
    t_end: float
    chunks: List[Chunk]
    requests: List[Request]
    sizes: dict
    counters: dict
    trace: Optional[dict]


class Clock:
    """The measured window as the workers see it: they wait for ``go``,
    read ``open`` and ``close`` then, stop where their traffic says
    (``stop`` is set at the close, or on the first error), and wrap their
    calls in ``span``, which a traced run records in ``spans``."""

    def __init__(self, seconds: float, trace: bool):
        self.seconds = seconds
        self.go, self.stop = threading.Event(), threading.Event()
        self.open = self.close = None
        self.errors: list = []
        self.spans: list = []  # (name, start, end), host seconds
        self.span = self._recorded if trace else contextlib.nullcontext

    @contextlib.contextmanager
    def _recorded(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.perf_counter()))

    def fail(self, who: str) -> None:
        """Record the running exception and stop every worker."""
        self.errors.append(f"{who}: {traceback.format_exc()}")
        self.stop.set()


# ------------------------------------------------------------- the run ---

def host_probe_ms(n: int = 400_000) -> float:
    """Milliseconds a fixed pure-Python loop takes: how fast the host runs
    this interpreter at the moment (the sessions' host work is such
    Python).  Read before and after the window, for standard error."""
    t = time.perf_counter()
    x = 0
    for i in range(n):
        x += i & 7
    return (time.perf_counter() - t) * 1e3


def _delta(after, before):
    if isinstance(after, dict):
        return {k: _delta(after[k], before.get(k, 0)) for k in after}
    return after - before


def run_cell(cell: str, seed: int, seconds: float, trace: bool = False,
             device: str = "cuda", *, spec: dict | None = None,
             config: dict | None = None, mix: dict | None = None,
             t_start: float | None = None, note=None) -> tuple:
    """Run ``cell`` once; returns ``(result, check_lines)``: the result
    line's object and the compared numbers, each beside its limit.
    ``config`` and ``mix`` replace the cell's files (the CPU tests' small
    sizes, a sweep's rates); ``t_start`` is the process's start on the
    perf_counter clock."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    note = note or (lambda msg: print(msg, file=sys.stderr, flush=True))
    spec = load_spec() if spec is None else spec
    entry = cell_of(spec, cell)
    cfg_file = config_of(spec, entry["config"]) if config is None else config
    mix = mix_of(entry["traffic"]) if mix is None else mix
    gen = generator_of(mix["generator"])
    gen.check_mix(mix)
    dev = torch.device(device)
    t0 = time.perf_counter()
    torch.empty(1, device=dev)
    note(f"bench: set-up: imports {t0 - t_start} s, device "
         f"{time.perf_counter() - t0} s")

    # ---- set-up and warm-up: the traffic's own ----
    traffic = gen.Traffic(cfg_file, mix, seed, dev, note)
    clock = Clock(seconds, trace)
    threads = [threading.Thread(target=w, daemon=True)
               for w in traffic.workers(clock)]
    for t in threads:
        t.start()
    traffic.sync()
    before = traffic.counters()
    gc.collect()
    gc.freeze()
    probe = [host_probe_ms()]
    prof = window_span = None
    if trace:
        from bench import devtrace
        prof = devtrace.profiler(torch)
        t_prof = time.perf_counter()
        prof.start()
        note(f"bench: the profiler started in "
             f"{time.perf_counter() - t_prof} s")
        from torch.profiler import record_function
        window_span = record_function(devtrace.WINDOW_SPAN)
        window_span.__enter__()
        anchor = time.perf_counter()

    # ---- the measured window ----
    clock.open = time.perf_counter()
    clock.close = clock.open + seconds
    setup_s = clock.open - t_start
    clock.go.set()
    clock.stop.wait(seconds)
    clock.stop.set()
    for t in threads:
        t.join(timeout=max(0.0, clock.close + JOIN_S - time.perf_counter()))
    traffic.sync()
    t_end = time.perf_counter()
    if trace:
        window_span.__exit__(None, None, None)
        prof.stop()
    gc.unfreeze()
    probe.append(host_probe_ms())
    hung = [t.name for t in threads if t.is_alive()]
    if hung:
        clock.errors.append(f"{len(hung)} workers still busy {JOIN_S} s "
                            f"after the close")
    counters = _delta(traffic.counters(), before)
    t_sum = time.perf_counter()
    summary = devtrace.summarize(prof, torch, clock.spans, anchor) \
        if trace else None
    t_sum = time.perf_counter() - t_sum
    del prof
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else 0

    # ---- the program's outputs; its state freed; the check ----
    traffic.finish()
    checks = traffic.check(note)
    for e in clock.errors:
        note(e)
    unanswered = sum(c.n_ops for c in traffic.chunks if c.ok is None) + \
        sum(r.u.shape[0] for r in traffic.requests if r.values is None)
    checks["unanswered"] = (unanswered, 0)
    correct = not clock.errors and all(v <= lim for v, lim in
                                       checks.values())
    run = Run(cell, cfg_file, mix, seconds, setup_s, clock.open,
              clock.close, t_end, traffic.chunks, traffic.requests,
              traffic.sizes, counters, summary)
    metrics = {}
    for m in metrics_of(spec, cell, trace):
        value = reader_of(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
                "count": 1, "memory_peak_bytes": int(peak)}
    if summary is not None:
        dev_info.update(busy_s=summary["busy_s"],
                        window_s=summary["window_s"])
    note(f"bench: {cell} seed {seed}: setup_s {setup_s}, window "
         f"{t_end - clock.open} s, trace reduced in {t_sum} s, host probe "
         f"{probe[0]} / {probe[1]} ms before / after; "
         f"{traffic.describe()}; counters {counters}")
    result = {
        "correct": bool(correct),
        "attempted": int(sum(c.n_ops for c in traffic.chunks)
                         + sum(r.u.shape[0] for r in traffic.requests)),
        "failed": int(unanswered),
        "metrics": metrics,
        "device": dev_info,
    }
    if summary is not None:
        result["breakdown"] = summary["breakdown"]
    result["checks"] = {k: {"value": int(v), "limit": lim}
                        for k, (v, lim) in checks.items()}
    lines = [f"check {k} {int(v)} limit {lim}"
             for k, (v, lim) in checks.items()]
    return result, lines
