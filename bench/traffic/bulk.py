"""The sliding-window edge mix over a graph that the service loads whole.

The same traffic as :mod:`bench.traffic.window` (its rings, typed ops,
fill, workers, outputs and check are inherited unchanged) over the same
preloaded draw, with one difference in set-up: the service is built by the
port's bulk load, ``SCCService.from_edges``, which places every preloaded
edge, growing the table where keys exhaust the probe bound, in place of
``graph_state.from_arrays``, which counts such keys and drops them.  So a
deployment whose preload fills half its table, the reference's
``update_16m``, starts from the whole graph the check replays.

A mix names this module in ``generator`` and has the keys of
:data:`MIX_KEYS`, window's own.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from bench.harness import Chunk, Request
from bench.traffic import window

MIX_KEYS = dict(window.MIX_KEYS, generator="this module: bulk")


def check_mix(mix: dict) -> dict:
    return window.check_mix(mix, MIX_KEYS, "bulk")


class Traffic(window.Traffic):
    """window's traffic over a service built by ``SCCService.from_edges``
    from window's preload."""

    def __init__(self, cfg_file: dict, mix: dict, seed: int, dev, note):
        from repro_torch.api import AddEdge, GraphClient, Reachable, \
            RemoveEdge
        from repro_torch.core.broker import QueryBroker
        from repro_torch.core.service import SCCService

        load = SCCService.from_edges  # before any work on the card
        t0 = time.perf_counter()
        self.mix, self.seed, self.dev = mix, seed, dev
        self.Reachable = Reachable
        nv = self.nv = cfg_file["n_vertices"]
        self.bucket = cfg_file["bucket"]
        cfg = window.graph_config(cfg_file)

        self.pre_src, self.pre_dst = window.preload(
            nv, cfg_file["preload_out_degree"], seed, dev)
        self.svc = load(cfg, self.pre_src, self.pre_dst,
                        buckets=(self.bucket,),
                        scan_lengths=tuple(cfg_file["scan_lengths"]),
                        device=dev, **cfg_file["service"])
        self.gen0 = self.svc.gen
        loaded_cap = self.svc.cfg.edge_capacity
        load_grows = self.svc.grow_count
        t1 = time.perf_counter()
        pre_keys = torch.unique(self.pre_src.long() * nv
                                + self.pre_dst.long())
        self.rings = window.Rings(nv, mix, pre_keys, seed, dev, self.draw)
        self.sizes = {"n_vertices": nv, "bucket": self.bucket,
                      "live_edges": int(pre_keys.numel())
                      + self.rings.live_adds(),
                      "steps_per_chunk": -(-mix["chunk_ops"] // self.bucket)}
        del pre_keys
        cls = {window.ADD_EDGE: AddEdge, window.REM_EDGE: RemoveEdge}

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
        self.pool = window.reader_pairs(nv, mix, seed) if mix["readers"] \
            else None
        for size in sorted(set(mix["broker_buckets"])) if self.readers \
                else ():  # each bucket's sweep, once
            self._send(self.readers[0], Request(
                -1, self.pool[0][:size], self.pool[1][:size],
                time.perf_counter()))
        t3 = time.perf_counter()
        note(f"bench: set-up: bulk load {t1 - t0} s ({load_grows} "
             f"grows, {self.svc.load_replaced_keys} keys placed after one, "
             f"capacity {loaded_cap}), rings and typed ops {t2 - t1} s, "
             f"fill and warm-up {t3 - t2} s (capacity "
             f"{self.svc.cfg.edge_capacity}, {self.svc.grow_count} grows)")
        self.lock = threading.Lock()
        self.next_request = 0
