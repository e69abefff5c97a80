"""The sliding-window edge mix over one SMSCC graph service.

Its draws are those of the paper's op stream (arXiv:1804.01276, Fig 4a
without vertex ops: uniform endpoints, half AddEdge and half RemoveEdge),
arranged so that the graph keeps its size through a window of any length.
Uniform RemoveEdge endpoints would miss on a graph of 2^20 vertices and
2^21 edges (a random pair is live with probability about 2e-6), so the
graph would only grow.  Here each update session cycles a ring of
``ring`` chunks: chunk p adds the fresh pairs A_p and removes the pairs
A_(p - lag) it added ``lag`` chunks earlier, each chunk's lanes
interleaved in a seeded order.  Set-up adds A_0 .. A_(lag-1) (the fill),
so every timed RemoveEdge names a live edge and the live edge count is the
same at every chunk boundary.  The pairs of every ring are distinct from
each other and from the preloaded graph, over all sessions.

Readers, where the mix has them, send Reachable requests of uniform
pairs at Poisson arrivals, open loop: every seed gets the same set of
gaps, in its own order, so a window holds the same number of requests
whatever the seed.  Each reader thread takes the next request due, waits
for its arrival and sends it; a request's latency runs from its arrival.
Readers send nothing once the window has closed: above capacity, the
requests still due then are never sent, and the window's work is what was
sent in it.

The system under test is the port's public serving entry: typed ops
through ``repro_torch.api.GraphClient.submit_many``, one client a thread,
over one ``SCCService`` and, where the mix has readers, one shared
``QueryBroker`` fed by its dispatcher thread.  Building the update rings'
typed ops is the clients' cost and is set-up; a reader builds each
request as its client would.

A mix is a data file, ``bench/traffic/<name>.json``, with the keys of
:data:`MIX_KEYS`.  Everything is drawn from ``seed``: the preloaded graph
with a ``torch.Generator`` on the run's device, the rest with numpy.  The
check replays every committed chunk through the plain reference
(``bench/reference/smscc.py``) in the order of the generations the service
stamped on them: every ack, the generations, a sample of the Reachable
answers drawn from the seed (each against the graph of the generation it
reports), the live edge set and the SCC partition of the last committed
state.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from bench.harness import Chunk, Request

ADD_EDGE = 0
REM_EDGE = 1

MIX_KEYS = {
    "generator": "this module: window",
    "sessions": "update sessions, each on its own thread",
    "chunk_ops": "ops in each update chunk (one submit_many)",
    "ring": "chunks in each session's ring",
    "lag": "chunks between a pair's AddEdge and its RemoveEdge",
    "rate_ops_per_s": "offered update ops/s over all sessions; 0 is a "
                      "closed loop",
    "readers": "reader threads; each sends the next request due",
    "reader_rate_queries_per_s": "offered Reachable ops/s, open loop",
    "reader_batch": "Reachable ops in each request",
    "reader_pool": "(u, v) pairs drawn for the readers, used in turn",
    "broker_buckets": "batch sizes of the shared query broker",
    "reach_check_sample": "Reachable answers the check compares, drawn "
                          "from the seed",
}


def check_mix(mix: dict, keys: dict = MIX_KEYS,
              generator: str = "window") -> dict:
    """Reject a mix with unknown or missing keys, a ring that would remove
    a pair before it is added, or readers with no rate.  A generator that
    builds on this one passes its own ``keys`` and name."""
    missing = set(keys) - set(mix)
    extra = set(mix) - set(keys) - {"why"}
    if missing or extra:
        raise ValueError(f"mix keys: missing {sorted(missing)}, unknown "
                         f"{sorted(extra)}")
    if mix["generator"] != generator:
        raise ValueError(f"not a mix of the generator {generator}")
    if mix["sessions"] < 1 or mix["chunk_ops"] < 2 or mix["chunk_ops"] % 2:
        raise ValueError("need a session and an even chunk of ops")
    if not 1 <= mix["lag"] or mix["ring"] < 2 * mix["lag"]:
        raise ValueError("the ring must hold at least twice the lag")
    if mix["readers"] and (mix["reader_rate_queries_per_s"] <= 0
                           or mix["reader_pool"] < mix["reader_batch"]):
        raise ValueError("readers need a rate and a pool of a batch")
    return mix


def seed_for(seed: int, *stream: int) -> int:
    """A 63-bit seed for one stream of draws of the run's ``seed``."""
    ss = np.random.SeedSequence([int(seed), *stream])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def preload(nv: int, out_degree: int, seed: int, device) -> tuple:
    """``out_degree`` out-edges per vertex to uniform targets: int32
    (src, dst) on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed_for(seed, 0))
    src = torch.arange(nv, dtype=torch.int32, device=device)
    src = src.repeat_interleave(out_degree)
    dst = torch.randint(0, nv, (src.numel(),), generator=g, device=device,
                        dtype=torch.int32)
    return src, dst


def fresh_pairs(nv: int, n: int, taken: torch.Tensor, seed: int,
                device) -> tuple:
    """``n`` distinct uniform pairs whose keys ``u * nv + v`` are not in
    ``taken`` (int64 keys on ``device``), in draw order: int64 (u, v) on
    the host."""
    g = torch.Generator(device=device).manual_seed(seed_for(seed, 1))
    kept = torch.empty(0, dtype=torch.long, device=device)
    while kept.numel() < n:
        m = n - kept.numel()
        m += m // 8 + 1024
        u = torch.randint(0, nv, (m,), generator=g, device=device)
        v = torch.randint(0, nv, (m,), generator=g, device=device)
        cand = torch.cat([kept, u * nv + v])
        order = torch.argsort(cand, stable=True)
        first = torch.ones(cand.numel(), dtype=torch.bool, device=device)
        first[order[1:]] = cand[order[1:]] != cand[order[:-1]]
        kept = cand[first & ~torch.isin(cand, taken)]
    kept = kept[:n].cpu().numpy()
    return kept // nv, kept % nv


class Rings:
    """The update chunks of every session, as (kind, u, v) int32 arrays:
    ``fill[s]`` once in set-up, then ``chunk(s, j)`` for j = 0, 1, ...
    in the window."""

    def __init__(self, nv: int, mix: dict, taken: torch.Tensor, seed: int,
                 device, draw=fresh_pairs):
        self.mix = mix
        s, ring, lag = mix["sessions"], mix["ring"], mix["lag"]
        half = mix["chunk_ops"] // 2
        u, v = draw(nv, s * ring * half, taken, seed, device)
        u = u.astype(np.int32).reshape(s, ring, half)
        v = v.astype(np.int32).reshape(s, ring, half)
        self.fill = []
        self.ring = []
        for si in range(s):
            fk = np.full(lag * half, ADD_EDGE, np.int32)
            self.fill.append((fk, u[si, :lag].ravel(), v[si, :lag].ravel()))
            rng = np.random.default_rng(seed_for(seed, 2, si))
            chunks = []
            for p in range(ring):
                q = (p - lag) % ring
                pos = rng.permutation(2 * half)
                kind = np.empty(2 * half, np.int32)
                cu = np.empty(2 * half, np.int32)
                cv = np.empty(2 * half, np.int32)
                kind[pos[:half]] = ADD_EDGE
                cu[pos[:half]], cv[pos[:half]] = u[si, p], v[si, p]
                kind[pos[half:]] = REM_EDGE
                cu[pos[half:]], cv[pos[half:]] = u[si, q], v[si, q]
                chunks.append((kind, cu, cv))
            self.ring.append(chunks)

    def position(self, j: int) -> int:
        """The ring position of a session's j-th window chunk."""
        return (self.mix["lag"] + j) % self.mix["ring"]

    def chunk(self, session: int, j: int) -> tuple:
        return self.ring[session][self.position(j)]

    def live_adds(self) -> int:
        """Ring pairs live at every chunk boundary, over all sessions."""
        m = self.mix
        return m["sessions"] * m["lag"] * (m["chunk_ops"] // 2)


def reader_pairs(nv: int, mix: dict, seed: int) -> tuple:
    """The readers' pool of uniform (u, v) query pairs, int32."""
    rng = np.random.default_rng(seed_for(seed, 3))
    n = mix["reader_pool"]
    return (rng.integers(0, nv, n).astype(np.int32),
            rng.integers(0, nv, n).astype(np.int32))


def arrivals(mix: dict, seconds: float, seed: int) -> np.ndarray:
    """The readers' request arrivals, seconds into the window: a Poisson
    stream at the mix's rate, as one fixed set of gaps (the same for every
    seed) in the seed's order, scaled so that all fall in the window."""
    n = int(round(mix["reader_rate_queries_per_s"] / mix["reader_batch"]
                  * seconds))
    if n == 0:
        return np.zeros(0)
    gaps = np.random.default_rng(seed_for(0, 5)).exponential(1.0, n)
    gaps *= seconds / gaps.sum()
    gaps = gaps[np.random.default_rng(seed_for(seed, 5)).permutation(n)]
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


def graph_config(cfg_file: dict):
    from repro_torch.core import graph_state as gs
    eng = dict(cfg_file["engine"])
    eng["region_edge_buckets"] = tuple(eng["region_edge_buckets"])
    return gs.GraphConfig(n_vertices=cfg_file["n_vertices"],
                          edge_capacity=cfg_file["edge_capacity"], **eng)


class Traffic:
    """Set-up, the window's workers and the check of one run (see the
    module's docstring and :mod:`bench.harness`).  A generator that builds
    on this one replaces what it changes: ``draw``, the update pairs'
    draw, or ``_send``, a reader's request."""

    draw = staticmethod(fresh_pairs)

    def __init__(self, cfg_file: dict, mix: dict, seed: int, dev, note):
        from repro_torch.api import AddEdge, GraphClient, Reachable, \
            RemoveEdge
        from repro_torch.core import dynamic
        from repro_torch.core import graph_state as gs
        from repro_torch.core.broker import QueryBroker
        from repro_torch.core.service import SCCService

        t0 = time.perf_counter()
        self.mix, self.seed, self.dev = mix, seed, dev
        self.Reachable = Reachable
        nv = self.nv = cfg_file["n_vertices"]
        self.bucket = cfg_file["bucket"]
        cfg = graph_config(cfg_file)

        self.pre_src, self.pre_dst = preload(
            nv, cfg_file["preload_out_degree"], seed, dev)
        state = dynamic.recompute(gs.from_arrays(
            cfg, self.pre_src, self.pre_dst, device=dev), cfg)
        overflow = int(state.overflow)
        t1 = time.perf_counter()
        self.svc = SCCService(cfg, buckets=(self.bucket,), state=state,
                              scan_lengths=tuple(cfg_file["scan_lengths"]),
                              device=dev, **cfg_file["service"])
        del state
        self.gen0 = self.svc.gen
        pre_keys = torch.unique(self.pre_src.long() * nv
                                + self.pre_dst.long())
        self.rings = Rings(nv, mix, pre_keys, seed, dev, self.draw)
        self.sizes = {"n_vertices": nv, "bucket": self.bucket,
                      "live_edges": int(pre_keys.numel())
                      + self.rings.live_adds(),
                      "steps_per_chunk": -(-mix["chunk_ops"] // self.bucket)}
        del pre_keys
        cls = {ADD_EDGE: AddEdge, REM_EDGE: RemoveEdge}

        def typed(arrays):
            kind, u, v = arrays
            out = np.empty(kind.shape[0], dtype=object)
            for k, c in cls.items():
                m = kind == k
                out[m] = list(map(c, u[m].tolist(), v[m].tolist()))
            return out.tolist()

        n_s = mix["sessions"]
        self.typed = [[typed(self.rings.ring[s][p])
                       for p in range(mix["ring"])] for s in range(n_s)]
        t2 = time.perf_counter()
        self.broker = None
        if mix["readers"]:
            self.broker = QueryBroker(self.svc,
                                      buckets=tuple(mix["broker_buckets"]))
            self.broker.start()
        self.sessions = [GraphClient(self.svc, broker=self.broker)
                         for _ in range(n_s)]
        self.readers = [GraphClient(self.svc, broker=self.broker)
                        for _ in range(mix["readers"])]
        self.all_chunks: list = []
        self.all_requests: list = []
        for s in range(n_s):  # the fill; the first also captures the step
            c = Chunk(s, -1, self.rings.fill[s], time.perf_counter())
            self._submit_chunk(c, typed(self.rings.fill[s]))
        self.pool = reader_pairs(nv, mix, seed) if mix["readers"] else None
        for size in sorted(set(mix["broker_buckets"])) if self.readers \
                else ():  # each bucket's sweep, once
            self._send(self.readers[0], Request(
                -1, self.pool[0][:size], self.pool[1][:size],
                time.perf_counter()))
        t3 = time.perf_counter()
        note(f"bench: set-up: graph {t1 - t0} s ({overflow} edges past "
             f"the probe bound), service and typed rings {t2 - t1} s, "
             f"fill and warm-up {t3 - t2} s")
        self.lock = threading.Lock()
        self.next_request = 0

    # ---- the window ----

    def _submit_chunk(self, c: Chunk, ops) -> None:
        self.all_chunks.append(c)
        res = self.sessions[c.session].submit_many(ops)
        c.t_ack, c.gen = time.perf_counter(), res[0].gen
        c.ok = np.fromiter((r.value for r in res), bool, len(res))

    def _send(self, client, req: Request) -> None:
        self.all_requests.append(req)
        ops = [self.Reachable(x, y)
               for x, y in zip(req.u.tolist(), req.v.tolist())]
        res = client.submit_many(ops)
        req.t_ack, req.gen = time.perf_counter(), res[0].gen
        req.values = [x.value for x in res]

    def workers(self, clock) -> list:
        mix = self.mix
        n_s = mix["sessions"]
        interval = (n_s * mix["chunk_ops"] / mix["rate_ops_per_s"]
                    if mix["rate_ops_per_s"] else None)
        due = arrivals(mix, clock.seconds, self.seed) if mix["readers"] \
            else None

        def update_session(s: int):
            clock.go.wait()
            try:
                j = 0
                while True:
                    t_due = None
                    if interval is None:
                        if clock.stop.is_set():
                            break
                    else:
                        t_due = clock.open + (j + s / n_s) * interval
                        if t_due >= clock.close or clock.errors:
                            break
                        time.sleep(max(0.0, t_due - time.perf_counter()))
                    c = Chunk(s, j, self.rings.chunk(s, j),
                              time.perf_counter())
                    if t_due is not None:
                        c.late_s = max(0.0, c.t_submit - t_due)
                    with clock.span("bench.update_chunk"):
                        self._submit_chunk(
                            c, self.typed[s][self.rings.position(j)])
                    j += 1
            except Exception:
                clock.fail(f"update session {s}")

        def reader(r: int):
            pu, pv = self.pool
            batch, pool = mix["reader_batch"], mix["reader_pool"]
            clock.go.wait()
            try:
                while not clock.errors:
                    with self.lock:
                        i = self.next_request
                        self.next_request += 1
                    if i >= due.shape[0]:
                        break
                    t_due = clock.open + due[i]
                    time.sleep(max(0.0, t_due - time.perf_counter()))
                    if time.perf_counter() >= clock.close:
                        break
                    a = (i * batch) % (pool - pool % batch)
                    with clock.span("bench.reach_request"):
                        self._send(self.readers[r], Request(
                            r, pu[a:a + batch], pv[a:a + batch], t_due))
            except Exception:
                clock.fail(f"reader {r}")

        return ([lambda s=s: update_session(s) for s in range(n_s)]
                + [lambda r=r: reader(r) for r in range(mix["readers"])])

    def sync(self) -> None:
        from repro_torch.core import step_graph
        step_graph.synchronize(self.dev)

    def counters(self) -> dict:
        svc = self.svc
        out = {"service": {a: getattr(svc, a) for a in (
            "pipelined_chunks", "fallback_chunks", "grow_count",
            "compaction_count", "scanned_chunks", "replayed_ops")}}
        if self.broker is not None:
            out["broker"] = {"flushes": self.broker.flushes,
                             "served": self.broker.served}
        if self.dev.type == "cuda":
            from repro_torch.kernels.frontier_expand import ops as fops
            out["fixpoint_rounds"] = fops.fixpoint_rounds()
        return out

    @property
    def chunks(self) -> list:
        return [c for c in self.all_chunks if c.j >= 0]

    @property
    def requests(self) -> list:
        return [r for r in self.all_requests if r.reader >= 0]

    def describe(self) -> str:
        chunks, reqs = self.chunks, self.requests
        commit_ms = [round(1e3 * (c.t_ack - c.t_submit)) for c in chunks
                     if c.t_ack is not None]
        out = (f"{len(chunks)} chunks, most late "
               f"{max((c.late_s for c in chunks), default=0)} s, chunk ms "
               f"{commit_ms[:12]}; {len(reqs)} requests")
        lat = [r.t_ack - r.t_submit for r in reqs if r.t_ack is not None]
        if lat:
            pct = np.percentile(lat, [50, 90, 95, 99, 100])
            out += " of ms p50/p90/p95/p99/max " + " ".join(
                f"{1e3 * x:.2f}" for x in pct)
        return out

    def finish(self) -> None:
        """Take the last committed state's live edges and labels to the
        host; stop the broker and the clients; free the program's state."""
        from repro_torch.core import step_graph
        head_state, self.head_gen = self.svc.head
        t = head_state.edges
        live = t.state == 1
        self.got_keys = torch.sort(t.src[live].long() * self.nv
                                   + t.dst[live].long())[0].cpu()
        self.got_ccid = head_state.ccid.long().cpu()
        if self.broker is not None:
            self.broker.stop()
        for c in self.sessions + self.readers:
            c.close()
        del head_state, t, live
        self.svc = self.broker = self.sessions = self.readers = None
        self.typed = None
        import gc
        gc.collect()
        step_graph.clear()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ---- the check ----

    def check(self, note) -> dict:
        """The compared numbers, each ``(value, limit)``; all are counts
        that a sound run leaves at 0."""
        from bench.reference import smscc as ref

        t0 = time.perf_counter()
        nv, bucket, dev = self.nv, self.bucket, self.dev
        done = sorted((c for c in self.all_chunks if c.gen is not None),
                      key=lambda c: c.gen)
        gens = [self.gen0] + [c.gen for c in done]
        gen_errors = int(len(set(gens)) != len(gens))
        answered = [r for r in self.all_requests if r.values is not None]
        committed = set(gens)
        gen_errors += sum(r.gen not in committed for r in answered)
        # the sample of Reachable answers, grouped by generation
        none = np.zeros(0, np.int32)
        us = np.concatenate([r.u for r in answered]) if answered else none
        vs = np.concatenate([r.v for r in answered]) if answered else none
        vals = np.concatenate([np.asarray(r.values, bool)
                               for r in answered]) if answered else none
        qgen = np.concatenate([np.full(r.u.shape[0], r.gen)
                               for r in answered]) if answered else none
        n_sample = min(self.mix["reach_check_sample"], us.shape[0])
        pick = np.random.default_rng(seed_for(self.seed, 4)).choice(
            us.shape[0], n_sample, replace=False) if n_sample else \
            np.zeros(0, np.int64)
        by_gen: dict = {}
        for i in pick.tolist():
            by_gen.setdefault(int(qgen[i]), []).append(i)

        replay = ref.EdgeSetReplay(nv, self.pre_src.to(dev),
                                   self.pre_dst.to(dev))
        reach_bad = 0

        def answer(gen):
            nonlocal reach_bad
            idx = by_gen.pop(gen, None)
            if not idx:
                return
            src, dst = replay.edges()
            want = ref.reachable(nv, src, dst, torch.from_numpy(us[idx]),
                                 torch.from_numpy(vs[idx])).cpu().numpy()
            reach_bad += int(np.sum(want != vals[idx]))

        ack_bad = 0
        cur = self.gen0
        answer(cur)
        for c in done:
            kind, u, v = c.arrays
            steps = range(0, kind.shape[0], bucket)
            # each step commits a generation of its own; a grow-and-replay
            # commits its replayed steps under further ones
            if c.gen < cur + len(steps):
                gen_errors += 1
            ok = np.concatenate([
                replay.step(*(torch.from_numpy(x[lo:lo + bucket])
                              for x in (kind, u, v))).cpu().numpy()
                for lo in steps])
            ack_bad += int(np.sum(ok != c.ok))
            cur = c.gen
            answer(cur)
        gen_errors += len(by_gen)  # sampled answers at no commit replayed
        if self.head_gen != cur:
            gen_errors += 1
        want_keys = replay.live
        got_keys = self.got_keys.to(want_keys.device)
        edge_bad = int((~torch.isin(got_keys, want_keys)).sum()
                       + (~torch.isin(want_keys, got_keys)).sum()
                       + got_keys.numel() - torch.unique(got_keys).numel())
        src, dst = replay.edges()
        want_ccid = ref.scc_labels(nv, src, dst)
        part_bad = int((want_ccid != self.got_ccid.to(want_ccid.device))
                       .sum())
        note(f"bench: check {time.perf_counter() - t0} s; {len(done)} "
             f"chunks, {n_sample} of {us.shape[0]} Reachable answers "
             f"compared")
        out = {"ack_mismatches": (ack_bad, 0), "gen_errors": (gen_errors, 0)}
        if self.mix["readers"]:
            out["reach_mismatches"] = (reach_bad, 0)
        out["edge_set_mismatches"] = (edge_bad, 0)
        out["partition_mismatches"] = (part_bad, 0)
        return out
