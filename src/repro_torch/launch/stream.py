"""Bucketed stream scheduling and the typed-client stream drivers (a port
of ``repro.launch.stream``).

The scheduler cuts an arbitrary-length op chunk into a small registry of
batch shapes: the largest buckets that fit, and the tail padded with NOP
lanes up to the smallest bucket that holds it.  The drivers
(`run_stream`, `run_concurrent_stream`) speak the typed API: every update
and query goes through a :class:`repro_torch.api.GraphClient` session.
"""
from __future__ import annotations

import threading
import time
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import dynamic, step_graph

__all__ = ["BucketedScheduler", "run_stream", "run_concurrent_stream",
           "StreamReport", "typed_op_stream"]


class BucketedScheduler:
    """Cuts (kind, u, v) arrays into NOP-padded static-shape OpBatches."""

    def __init__(self, buckets: Sequence[int] = (64, 256, 1024)):
        self.buckets: Tuple[int, ...] = tuple(sorted(set(int(b)
                                                         for b in buckets)))
        if not self.buckets or self.buckets[0] <= 0:
            raise ValueError(f"need positive bucket sizes, got {buckets}")

    def plan(self, n: int) -> List[Tuple[slice, int]]:
        """[(slice into the chunk, bucket size)] covering [0, n)."""
        out: List[Tuple[slice, int]] = []
        pos = 0
        while pos < n:
            rest = n - pos
            fits = [b for b in self.buckets if b <= rest]
            # largest full bucket, else smallest bucket that covers the tail
            b = fits[-1] if fits else min(
                b for b in self.buckets if b >= rest)
            take = min(b, rest)
            out.append((slice(pos, pos + take), b))
            pos += take
        return out

    def chunks(self, kind, u, v) -> Iterator[
            Tuple[slice, dynamic.OpBatch]]:
        """Yield (slice, padded OpBatch); lanes past the slice are NOPs."""
        kind = np.asarray(kind, np.int32)
        u = np.asarray(u, np.int32)
        v = np.asarray(v, np.int32)
        for sl, b in self.plan(kind.shape[0]):
            pk = np.full(b, dynamic.NOP, np.int32)
            pu = np.zeros(b, np.int32)
            pv = np.zeros(b, np.int32)
            n = sl.stop - sl.start
            pk[:n] = kind[sl]
            pu[:n] = u[sl]
            pv[:n] = v[sl]
            yield sl, dynamic.make_ops(pk, pu, pv)

    def super_chunks(self, kind, u, v,
                     scan_lengths: Sequence[int] = (1, 4, 16)
                     ) -> Iterator[Tuple[List[slice], dynamic.OpBatch]]:
        """Group the bucket plan into stacked *super-chunks* for the fused
        ``dynamic.apply_batch_scan`` entry.

        Maximal runs of equal-bucket plan entries are cut greedily into
        the largest ``scan_lengths`` that fit (the registry always
        includes 1, so no run is ever NOP-step padded -- a super-chunk
        contains only real plan entries and the linearization is exactly
        the per-bucket order of :meth:`chunks`).  Yields
        ``([slice, ...], OpBatch)`` where the batch carries
        ``int32[K, B]`` leaves, one stacked row per covered slice.
        """
        lens = tuple(sorted({int(s) for s in scan_lengths} | {1}))
        if lens[0] <= 0:
            raise ValueError(f"scan lengths must be positive: {lens}")
        kind = np.asarray(kind, np.int32)
        u = np.asarray(u, np.int32)
        v = np.asarray(v, np.int32)
        plan = self.plan(kind.shape[0])
        i = 0
        while i < len(plan):
            b = plan[i][1]
            j = i
            while j < len(plan) and plan[j][1] == b:
                j += 1
            while i < j:  # cut the equal-bucket run [i, j) into scan steps
                k = max(s for s in lens if s <= j - i)
                group = plan[i:i + k]
                pk = np.full((k, b), dynamic.NOP, np.int32)
                pu = np.zeros((k, b), np.int32)
                pv = np.zeros((k, b), np.int32)
                for r, (sl, _) in enumerate(group):
                    n = sl.stop - sl.start
                    pk[r, :n] = kind[sl]
                    pu[r, :n] = u[sl]
                    pv[r, :n] = v[sl]
                yield ([sl for sl, _ in group],
                       dynamic.make_ops(pk, pu, pv))
                i += k


class StreamReport(dict):
    """Flat metrics dict with a pretty printer."""

    def pretty(self) -> str:
        return " | ".join(f"{k}={v}" for k, v in self.items())


def typed_op_stream(nv: int, n: int, *, step: int, add_frac: float,
                    seed: int = 0, include_vertex_ops: bool = True):
    """One deterministic chunk of typed update ops (paper workload mix)."""
    from repro_torch.api import updates_from_arrays
    from repro_torch.launch import workload

    ops = workload.op_stream(nv, n, step=step, add_frac=add_frac,
                             seed=seed,
                             include_vertex_ops=include_vertex_ops)
    return updates_from_arrays(np.asarray(ops.kind), np.asarray(ops.u),
                               np.asarray(ops.v))


def run_stream(service, n_ops: int, *, add_frac: float = 0.6,
               query_frac: float = 0.0, chunk: int = 512,
               n_queries: int = 256, include_vertex_ops: bool = True,
               seed: int = 0, budget_s: Optional[float] = None,
               record: Optional[list] = None) -> StreamReport:
    """Drive ``service`` with a synthetic mixed workload (paper Fig 4/5)
    through a single typed :class:`repro_torch.api.GraphClient` session.

    ``query_frac`` interleaves query batches (``n_queries`` SameSCC and
    up to 32 Reachable) between update chunks.  Each side is timed to a
    device synchronise and reported separately with the host syncs and
    kernel launches it made (``update_*`` / ``query_*``).  ``budget_s``
    stops the stream once that much time has passed, after at least one
    chunk (``chunks`` says how many ran); ``record`` collects every
    Result's ``(value, gen)``.  Deterministic in ``seed``.
    """
    from repro_torch import kernels
    from repro_torch.api import GraphClient, Reachable, SameSCC
    from repro_torch.core.broker import QueryBroker
    from repro_torch.core.sync import SYNCS

    nv = service.cfg.n_vertices
    rng = np.random.default_rng(seed)
    n_reach = min(32, n_queries)
    # bucket registry matched to the two query shapes issued below
    client = GraphClient(service, broker=QueryBroker(
        service, buckets=tuple(sorted({n_queries, n_reach}))))
    spent = {side: dict(s=0.0, syncs=0,
                        launches=dict.fromkeys(kernels.launch_counts(), 0))
             for side in ("update", "query")}

    def timed(side, fn):
        syncs, launches = SYNCS.count, kernels.launch_counts()
        t0 = time.perf_counter()
        out = fn()
        step_graph.synchronize(service.device)
        acc = spent[side]
        acc["s"] += time.perf_counter() - t0
        acc["syncs"] += SYNCS.count - syncs
        for k, n in kernels.launch_counts().items():
            acc["launches"][k] += n - launches[k]
        if record is not None:
            record.extend((r.value, r.gen) for r in out)
        return out

    applied = 0
    queries = 0
    accepted = 0
    step = 0
    try:
        while applied < n_ops:
            if budget_s is not None and step >= 1 and \
                    spent["update"]["s"] + spent["query"]["s"] > budget_s:
                break
            n = min(chunk, n_ops - applied)
            ops = typed_op_stream(nv, n, step=step, add_frac=add_frac,
                                  seed=seed,
                                  include_vertex_ops=include_vertex_ops)
            results = timed("update", lambda: client.submit_many(ops))
            accepted += sum(r.value for r in results)
            applied += n
            step += 1
            if query_frac > 0 and rng.random() < query_frac:
                qu = rng.integers(0, nv, n_queries)
                qv = rng.integers(0, nv, n_queries)
                same_ops = [SameSCC(int(a), int(b))
                            for a, b in zip(qu, qv)]
                reach_ops = [Reachable(int(a), int(b))
                             for a, b in zip(qu[:n_reach], qv[:n_reach])]
                same = timed("query", lambda: client.submit_many(same_ops))
                reach_ = timed("query",
                               lambda: client.submit_many(reach_ops))
                if same[0].gen != reach_[0].gen:
                    raise RuntimeError("snapshot generation drifted")
                queries += n_queries + n_reach
    finally:
        client.close()
    t_update, t_query = spent["update"]["s"], spent["query"]["s"]
    wall = t_update + t_query
    rep = StreamReport(
        ops=applied, chunks=step, accepted=accepted, queries=queries,
        update_s=t_update, query_s=t_query,
        ops_per_s=applied / t_update if t_update else 0.0,
        queries_per_s=queries / t_query if t_query else 0.0,
        combined_per_s=(applied + queries) / wall if wall else 0.0,
        update_syncs=spent["update"]["syncs"],
        query_syncs=spent["query"]["syncs"],
        update_launches=spent["update"]["launches"],
        query_launches=spent["query"]["launches"],
    )
    rep.update(client.stats())
    return rep


def run_concurrent_stream(service, n_ops: int, *, readers: int = 2,
                          add_frac: float = 0.6, chunk: int = 512,
                          n_queries: int = 256, reach_queries: int = 32,
                          include_vertex_ops: bool = True, seed: int = 0,
                          query_buckets: Sequence[int] | None = None,
                          record: Optional[list] = None) -> StreamReport:
    """The paper's serving shape: ``readers`` query threads overlap a live
    update stream (Fig 4/5's concurrent mode).

    The main thread applies the same deterministic typed update stream as
    :func:`run_stream` through its own :class:`repro_torch.api.GraphClient`
    session; meanwhile each reader thread holds its own client session
    over one shared, dispatcher-fed
    :class:`repro_torch.core.broker.QueryBroker` and issues coalesced
    SameSCC (and occasional Reachable) batches, checking that the
    generations it observes never go backwards.  Queries are
    free-running: throughput is whatever the readers manage while the
    updates execute.  The wall time ends in a device synchronise.
    ``record`` collects each reader batch as ``(reader, kind, u, v,
    values, gen)`` so a caller can check it against an oracle.
    """
    from repro_torch.api import GraphClient, Reachable, SameSCC
    from repro_torch.core.broker import QueryBroker

    nv = service.cfg.n_vertices
    # bucket registry sized to the two request shapes readers issue, so a
    # lone reachability batch is never padded up to the SameSCC size
    buckets = query_buckets or tuple(sorted(
        {n_queries} | ({reach_queries} if reach_queries else set())))
    broker = QueryBroker(service, buckets=buckets).start()
    updater = GraphClient(service, broker=broker)
    stop = threading.Event()
    q_counts = [0] * readers
    errors: list = []

    def reader(i: int):
        client = GraphClient(service, broker=broker)
        rng = np.random.default_rng(seed + 7919 * (i + 1))
        last_gen = -1
        try:
            while not stop.is_set():
                batches = [("same", rng.integers(0, nv, n_queries),
                            rng.integers(0, nv, n_queries))]
                if reach_queries and rng.random() < 0.25:
                    batches.append(("reach", batches[0][1][:reach_queries],
                                    batches[0][2][:reach_queries]))
                for kind, qu, qv in batches:
                    op = SameSCC if kind == "same" else Reachable
                    res = client.submit_many(
                        [op(int(a), int(b)) for a, b in zip(qu, qv)])
                    gen = res[0].gen
                    if gen < last_gen:
                        raise AssertionError(
                            f"reader {i} saw generation go backwards: "
                            f"{gen} < {last_gen}")
                    last_gen = gen
                    q_counts[i] += len(qu)
                    if record is not None:
                        record.append((i, kind, qu, qv,
                                       [r.value for r in res], gen))
        except Exception as e:  # surfaced after join
            errors.append(e)

    threads = [threading.Thread(target=reader, args=(i,), daemon=True)
               for i in range(readers)]
    applied = accepted = step = 0
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    try:
        while applied < n_ops:
            n = min(chunk, n_ops - applied)
            ops = typed_op_stream(nv, n, step=step, add_frac=add_frac,
                                  seed=seed,
                                  include_vertex_ops=include_vertex_ops)
            results = updater.submit_many(ops)
            accepted += sum(r.value for r in results)
            applied += n
            step += 1
    finally:
        stop.set()
        for t in threads:
            t.join()
        broker.stop()
    step_graph.synchronize(service.device)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    queries = sum(q_counts)
    rep = StreamReport(
        ops=applied, accepted=accepted, queries=queries, readers=readers,
        wall_s=wall,
        ops_per_s=applied / wall if wall else 0.0,
        queries_per_s=queries / wall if wall else 0.0,
        combined_per_s=(applied + queries) / wall if wall else 0.0,
    )
    rep.update(updater.stats())
    return rep
