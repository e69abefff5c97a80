"""The port's durability layer held to the JAX package: the write-ahead
op log, graph snapshots, crash recovery and the reference helpers the
serving path uses.

Both packages take the same op chunks from one carried state.  The WAL
segments they write must be the same bytes (rotation, the v2 epoch header
and fence markers included), each package must read the other's log and
open the other's store, and every recovery of the port's store (crash at
a segment boundary, torn tail, corrupt or missing snapshot, time travel)
must land on a committed generation whose state equals, leaf for leaf,
both the port's uninterrupted run and the JAX package's at that
generation.  Snapshot files carry zip timestamps, so they are compared by
keys, dtypes, shapes and contents.  Every value is an integer or a
boolean: equality is exact.  Crash points come from fixed seeds.
"""
import dataclasses
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import oplog as joplog
from repro.ckpt.durable import DurableService as JDurable
from repro.core import community as jcommunity
from repro.core import graph_state as jgs
from repro.core import reach as jreach
from repro_torch import carry
from repro_torch.ckpt import checkpoint, oplog
from repro_torch.ckpt.durable import (DurableService, scratch_replay,
                                      snap_dir, wal_dir)
from repro_torch.core import community, dynamic, reach
from repro_torch.core import graph_state as gs
from repro_torch.core import service as svc_mod
from repro_torch.core.service import SCCService

NV = 24
KNOBS = dict(buckets=(8,), proactive_grow=True)
QU = np.arange(8, dtype=np.int32) % NV
QV = (QU * 5 + 3) % NV


def jax_cfg(edge_capacity=64):
    return jgs.GraphConfig(n_vertices=NV, edge_capacity=edge_capacity,
                           max_probes=16, max_outer=NV + 1,
                           max_inner=NV + 2)


def tiny_cfg(edge_capacity=64):
    return carry.config_from_dict(dataclasses.asdict(
        jax_cfg(edge_capacity)))


def jax_arrays(st) -> dict:
    return {"v_alive": np.asarray(st.v_alive), "ccid": np.asarray(st.ccid),
            "src": np.asarray(st.edges.src), "dst": np.asarray(st.edges.dst),
            "state": np.asarray(st.edges.state),
            "n_ccs": np.asarray(st.n_ccs), "gen": np.asarray(st.gen),
            "overflow": np.asarray(st.overflow)}


def assert_arrays_equal(got: dict, want: dict, ctx=""):
    assert got.keys() == want.keys(), ctx
    for k in got:
        assert got[k].dtype == want[k].dtype, f"{ctx}: {k} dtype"
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{ctx}: {k}")


def random_ops(seed, n_chunks=6):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 4, 8).astype(np.int32),
             rng.integers(0, NV, 8).astype(np.int32),
             rng.integers(0, NV, 8).astype(np.int32))
            for _ in range(n_chunks)]


def both_runs(base, chunks, **durable_kw):
    """The port's and the JAX package's DurableService over the same
    chunks: acks must agree; returns (port writer, history of port
    states by gen, history of JAX states by gen)."""
    kw = dict(sync_every=1, snapshot_keep=10 ** 6, trim_on_snapshot=False,
              **KNOBS)
    kw.update(durable_kw)
    port = DurableService(tiny_cfg(), os.path.join(base, "port"),
                          state=gs.all_singletons(tiny_cfg(), "cpu"), **kw)
    ref = JDurable(jax_cfg(), os.path.join(base, "jax"),
                   state=jgs.all_singletons(jax_cfg()), **kw)
    hist = {port.gen: carry.state_to_numpy(port.state)}
    jhist = {ref.gen: jax_arrays(ref.state)}
    for kind, u, v in chunks:
        ok, gen = port._apply_ops(kind, u, v)
        jok, jgen = ref._apply_ops(kind, u, v)
        assert (ok.tolist(), gen) == (np.asarray(jok).tolist(), jgen)
        assert port.gen == int(port.state.gen)  # the host mirror holds
        hist[gen] = carry.state_to_numpy(port.state)
        jhist[jgen] = jax_arrays(ref.state)
    port.close()
    ref.close()
    return port, hist, jhist


def assert_on_history(rec, hist, jhist, ctx=""):
    """``rec`` sits on a committed generation of both runs, leaf for
    leaf, with the same query answers."""
    g = rec.gen
    assert g in hist and g in jhist, f"{ctx}: gen {g} is not a commit"
    got = carry.state_to_numpy(rec.state)
    assert_arrays_equal(got, hist[g], ctx)
    assert_arrays_equal(got, jhist[g], ctx + " vs jax")
    want = carry.state_from_numpy(hist[g], "cpu")
    np.testing.assert_array_equal(
        svc_mod.same_scc_on(rec.state, rec.cfg, QU, QV),
        svc_mod.same_scc_on(want, rec.cfg, QU, QV))
    return g


def seg_bytes(directory) -> dict:
    return {os.path.basename(p): open(p, "rb").read()
            for _, p in oplog.list_segments(directory)}


def flat(records):
    return [(r.gen_before, np.asarray(r.kind).tolist(),
             np.asarray(r.u).tolist(), np.asarray(r.v).tolist())
            for r in records]


# ------------------------------------------------------------ WAL unit ----


@pytest.mark.parametrize("epoch", [None, 3])
def test_wal_bytes_equal_jax_and_cross_read(tmp_path, epoch):
    """The same records through both packages' writers (rotation every
    ~200 bytes, an explicit writer epoch, a fence) give the same segment
    bytes and fence files; each package reads the other's log."""
    rng = np.random.default_rng(0)
    recs = []
    gen = 0
    for _ in range(12):
        n = int(rng.integers(1, 6))
        recs.append((gen, rng.integers(0, 4, n).astype(np.int32),
                     rng.integers(0, NV, n).astype(np.int32),
                     rng.integers(0, NV, n).astype(np.int32)))
        gen += 1
    dirs = {}
    for name, mod in (("port", oplog), ("jax", joplog)):
        d = str(tmp_path / name)
        w = mod.OpLogWriter(d, segment_bytes=200, sync_every=1, epoch=epoch)
        for g, k, u, v in recs:
            w.append(g, k, u, v)
            w.maybe_rotate(g + 1)
        w.close()
        mod.write_fence(d, (epoch or 0) + 1)
        dirs[name] = d
    assert len(oplog.list_segments(dirs["port"])) > 2
    assert seg_bytes(dirs["port"]) == seg_bytes(dirs["jax"])
    assert oplog.list_fences(dirs["port"]) == \
        joplog.list_fences(dirs["jax"]) == [(epoch or 0) + 1]
    want = [(g, k.tolist(), u.tolist(), v.tolist()) for g, k, u, v in recs]
    assert flat(oplog.read_log(dirs["jax"])) == want
    assert flat(joplog.read_log(dirs["port"])) == want
    hdr = oplog.segment_header(oplog.list_segments(dirs["port"])[-1][1])
    assert hdr.epoch == (epoch or 0) and hdr.size == oplog.SEG_HEADER_BYTES
    assert oplog.newest_epoch(dirs["port"]) == (epoch or 0) + 1


def test_v1_segment_reads_as_epoch_zero(tmp_path):
    d = str(tmp_path)
    w = oplog.OpLogWriter(d, sync_every=1, start_gen=5)
    one = np.asarray([1], np.int32)
    w.append(5, one * 3, one, one * 2)
    w.close()
    _, path = oplog.list_segments(d)[0]
    buf = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(oplog._SEG_HDR_V1.pack(oplog._SEG_MAGIC_V1, 5))
        f.write(buf[oplog.SEG_HEADER_BYTES:])
    hdr = oplog.segment_header(path)
    assert (hdr.base_gen, hdr.epoch, hdr.size) == (5, 0,
                                                   oplog._SEG_HDR_V1.size)
    assert flat(oplog.read_log(d)) == [(5, [3], [1], [2])]
    assert flat(joplog.read_log(d)) == [(5, [3], [1], [2])]


def test_torn_tail_at_every_offset_keeps_the_prefix(tmp_path):
    """Truncating the last segment at every byte offset of its last record
    yields a clean record prefix (the same one JAX reads), and
    repair_tail makes the store appendable again."""
    d = str(tmp_path / "wal")
    rng = np.random.default_rng(1)
    w = oplog.OpLogWriter(d, segment_bytes=200, sync_every=1)
    want, gen = [], 0
    for _ in range(9):
        n = int(rng.integers(1, 6))
        kind = rng.integers(0, 4, n).astype(np.int32)
        u = rng.integers(0, NV, n).astype(np.int32)
        v = rng.integers(0, NV, n).astype(np.int32)
        w.append(gen, kind, u, v)
        want.append((gen, kind.tolist(), u.tolist(), v.tolist()))
        gen += 1
        if len(want) < 9:  # the last segment keeps its records
            w.maybe_rotate(gen)
    w.close()
    _, last = oplog.list_segments(d)[-1]
    blob = open(last, "rb").read()
    n_prev = len(want) - len(oplog.read_segment(last)[0])
    assert n_prev < len(want)
    for off in range(len(blob) + 1):
        torn = str(tmp_path / "torn")
        shutil.rmtree(torn, ignore_errors=True)
        shutil.copytree(d, torn)
        with open(os.path.join(torn, os.path.basename(last)), "r+b") as f:
            f.truncate(off)
        got = flat(oplog.read_log(torn))
        assert got == want[:len(got)] == flat(joplog.read_log(torn))
        assert len(got) >= n_prev, f"offset {off}: lost sealed segments"
        oplog.repair_tail(torn)
        w2 = oplog.OpLogWriter(torn, segment_bytes=200, sync_every=1,
                               start_gen=gen)
        w2.append(gen, np.asarray([0], np.int32), np.asarray([1], np.int32),
                  np.asarray([2], np.int32))
        w2.close()
        assert flat(oplog.read_log(torn)) == got + [(gen, [0], [1], [2])]


def test_trim_keeps_coverage_and_fence_refuses_stale_writer(tmp_path):
    d = str(tmp_path / "wal")
    w = oplog.OpLogWriter(d, segment_bytes=64, sync_every=1)
    one = np.asarray([1], np.int32)
    for g in range(10):
        w.append(g, one * 3, one, one * 2)
        w.maybe_rotate(g + 1)
    oplog.trim(d, 7)
    gens = [r.gen_before for r in oplog.read_log(d)]
    assert gens[0] <= 7 and gens == list(range(gens[0], 10))
    oplog.write_fence(d, 1)
    before = sorted(os.listdir(d))
    from repro_torch.fault import errors as fault_errors
    with pytest.raises(fault_errors.Fenced):
        w.append(10, one, one, one)
    with pytest.raises(fault_errors.Fenced):
        oplog.OpLogWriter(d, start_gen=10, epoch=0)
    assert sorted(os.listdir(d)) == before


# ----------------------------------------------------------- snapshots ----


def test_snapshot_keys_dtypes_shapes_equal_jax(tmp_path):
    """One state snapshotted by both packages: same keys in the same
    order, dtypes, shapes and contents (meta included)."""
    jcfg = jax_cfg()
    jstate = jgs.from_arrays(jcfg, jnp.arange(10), (jnp.arange(10) + 3) % NV)
    tstate = carry.state_from_numpy(jax_arrays(jstate), "cpu")
    meta = {"gen": 0, "cfg": {"n_vertices": NV}, "service": {}}
    from repro.ckpt import checkpoint as jcheckpoint
    jcheckpoint.save_graph_snapshot(str(tmp_path / "jax"), jstate, meta)
    checkpoint.save_graph_snapshot(str(tmp_path / "port"), tstate, meta)
    with np.load(tmp_path / "jax" / "ckpt_0.npz") as zj, \
            np.load(tmp_path / "port" / "ckpt_0.npz") as zt:
        assert zj.files == zt.files
        assert "d:graph|a:edges|a:src" in zt.files and "d:meta" in zt.files
        for k in zj.files:
            assert zj[k].dtype == zt[k].dtype, k
            assert zj[k].shape == zt[k].shape, k
            np.testing.assert_array_equal(zj[k], zt[k], err_msg=k)
    assert [k for k, _ in checkpoint.leaves({"graph": tstate, "meta": 0})] \
        == zt.files


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_opens_across_packages(tmp_path, writer):
    """A store written by one package (boot snapshot, async snapshots,
    WAL) opens in the other at the same generation and state; the two
    packages' WAL segments are the same bytes."""
    port, hist, jhist = both_runs(str(tmp_path), random_ops(4),
                                  snapshot_every=2, segment_bytes=256)
    for _ in range(50):  # async snapshots landed before close() returned
        if port._snap_thread is None:
            break
    assert seg_bytes(wal_dir(str(tmp_path / "port"))) == \
        seg_bytes(wal_dir(str(tmp_path / "jax")))
    store = str(tmp_path / writer)
    if writer == "jax":
        rec = DurableService.open(store, device="cpu", snapshot_every=0)
        assert assert_on_history(rec, hist, jhist, "port opens jax") == \
            port.gen
        rec.close()
    else:
        rec = JDurable.open(store, snapshot_every=0)
        assert rec.gen == port.gen
        assert_arrays_equal(jax_arrays(rec.state), hist[port.gen],
                            "jax opens port")
        rec.close()


# ------------------------------------------------- crash-anywhere replay --


CRASH_CASES = [(0, 0), (1, 2), (2, 3)]  # (seed, snapshot_every)


@pytest.mark.parametrize("seed,snap_every", CRASH_CASES)
def test_crash_replay_bit_identical_to_uninterrupted_and_jax(
        tmp_path, seed, snap_every):
    """A durable run (tiny segments, optional async snapshots) is cut
    after every segment and torn at fixed offsets of its last segment;
    every recovery lands on a committed generation equal to the port's
    uninterrupted run and to the JAX package's, and equals
    scratch_replay (boot snapshot + full log) at that generation."""
    base = str(tmp_path)
    port, hist, jhist = both_runs(base, random_ops(10 + seed, 7),
                                  segment_bytes=192,
                                  snapshot_every=snap_every)
    store = os.path.join(base, "port")
    assert seg_bytes(wal_dir(store)) == \
        seg_bytes(wal_dir(os.path.join(base, "jax")))
    rec = DurableService.open(store, device="cpu", snapshot_every=0)
    assert assert_on_history(rec, hist, jhist, "intact") == port.gen
    rec.close()

    def keep_boot_snapshot_only(copy):
        for f in os.listdir(snap_dir(copy)):
            if f.startswith("ckpt_") and f != "ckpt_0.npz":
                os.remove(os.path.join(snap_dir(copy), f))

    segs = oplog.list_segments(wal_dir(store))
    assert len(segs) > 2
    cuts = [("boundary", i) for i in range(1, len(segs) + 1)]
    size = os.path.getsize(segs[-1][1])
    rng = np.random.default_rng(seed)
    cuts += [("torn", int(o)) for o in rng.integers(0, size + 1, 3)]
    for how, at in cuts:
        copy = os.path.join(base, f"{how}{at}")
        shutil.copytree(store, copy)
        keep_boot_snapshot_only(copy)
        if how == "boundary":
            for _, path in oplog.list_segments(wal_dir(copy))[at:]:
                os.remove(path)
        else:
            with open(os.path.join(wal_dir(copy),
                                   os.path.basename(segs[-1][1])),
                      "r+b") as f:
                f.truncate(at)
        rec = DurableService.open(copy, device="cpu", snapshot_every=0)
        g = assert_on_history(rec, hist, jhist, f"{how} {at}")
        scr = scratch_replay(copy, to_gen=g, device="cpu")
        assert_arrays_equal(carry.state_to_numpy(scr.state),
                            carry.state_to_numpy(rec.state), f"{how} {at}")
        rec.close()
        shutil.rmtree(copy)


def seed_store(base, n_chunks=6, seed=11, **durable_kw):
    kw = dict(sync_every=1, segment_bytes=256, snapshot_every=0,
              snapshot_keep=10 ** 6, trim_on_snapshot=False)
    kw.update(durable_kw)
    dsvc = DurableService(tiny_cfg(), str(base),
                          state=gs.all_singletons(tiny_cfg(), "cpu"),
                          **kw, **KNOBS)
    hist = {0: carry.state_to_numpy(dsvc.state)}
    for kind, u, v in random_ops(seed, n_chunks):
        dsvc._apply_ops(kind, u, v)
        hist[dsvc.gen] = carry.state_to_numpy(dsvc.state)
    return dsvc, hist


def test_mid_snapshot_crash_falls_back(tmp_path):
    """A corrupt newest snapshot (LATEST checksum mismatch) or a deleted
    one (LATEST dangling) falls back to an older snapshot and recovers
    the same final state through a longer replay."""
    store = tmp_path / "store"
    dsvc, hist = seed_store(store)
    dsvc.snapshot_now()
    for kind, u, v in random_ops(12, 3):
        dsvc._apply_ops(kind, u, v)
    dsvc.snapshot_now()
    final = carry.state_to_numpy(dsvc.state)
    dsvc.close()
    newest = f"ckpt_{dsvc.gen}.npz"
    for how in ("corrupt", "delete"):
        crash = str(tmp_path / how)
        shutil.copytree(store, crash)
        path = os.path.join(snap_dir(crash), newest)
        if how == "corrupt":
            with open(path, "r+b") as f:
                f.write(b"\0" * 16)
        else:
            os.remove(path)
        rec = DurableService.open(crash, device="cpu", snapshot_every=0)
        assert rec.gen == dsvc.gen
        assert_arrays_equal(carry.state_to_numpy(rec.state), final, how)
        assert rec.replayed_wal_records > 0
        rec.close()


def test_open_to_gen_stops_at_that_generation(tmp_path):
    dsvc, hist = seed_store(tmp_path)
    dsvc.close()
    commits = sorted(hist)
    for g in (commits[1], commits[len(commits) // 2], commits[-1]):
        rec = DurableService.open(str(tmp_path), to_gen=g, device="cpu")
        assert rec.gen == min(c for c in commits if c >= g)
        assert_arrays_equal(carry.state_to_numpy(rec.state), hist[rec.gen])
        assert rec._wal is None  # read-only: no WAL attached
        rec.close()


def test_failed_chunk_rolled_back_out_of_wal(tmp_path):
    """A chunk the service rejects wholesale (table full, growth
    forbidden) leaves no WAL record; recovery replays the accepted
    history only, and the host generation rolls back with the state."""
    cfg = tiny_cfg(edge_capacity=16)
    store = str(tmp_path / "store")
    dsvc = DurableService(cfg, store, state=gs.all_singletons(cfg, "cpu"),
                          buckets=(8,), max_edge_capacity=16, sync_every=1,
                          snapshot_every=0)
    pairs = [(a, b) for a in range(NV) for b in range(NV) if a != b]
    one = np.full(8, dynamic.ADD_EDGE, np.int32)

    def cols(lo, hi):
        return (np.asarray([p[0] for p in pairs[lo:hi]], np.int32),
                np.asarray([p[1] for p in pairs[lo:hi]], np.int32))

    gens = [0]
    for lo in (0, 8):
        dsvc._apply_ops(one, *cols(lo, lo + 8))
        gens.append(dsvc.gen)
    good_gen = dsvc.gen
    with pytest.raises(Exception):
        dsvc._apply_ops(one, *cols(16, 24))
    assert dsvc.gen == good_gen == int(dsvc.state.gen)
    assert dsvc.stats()["wal_rollbacks"] == 1
    dsvc._apply_ops(one[:1], *cols(9, 10))
    final, final_gen = carry.state_to_numpy(dsvc.state), dsvc.gen
    dsvc.close()
    assert [r.gen_before for r in oplog.read_log(wal_dir(store))] == gens
    rec = DurableService.open(store, device="cpu", snapshot_every=0)
    assert rec.gen == final_gen
    assert_arrays_equal(carry.state_to_numpy(rec.state), final)
    rec.close()


def test_recovery_after_trim(tmp_path):
    """With trim_on_snapshot, old segments go once a snapshot covers
    them, and recovery (snapshot + shorter tail) still equals the live
    state."""
    dsvc, _ = seed_store(tmp_path, n_chunks=10, segment_bytes=128,
                         snapshot_every=3, trim_on_snapshot=True,
                         snapshot_keep=3)
    if dsvc._snap_thread is not None:
        dsvc._snap_thread.join()
    dsvc.snapshot_now()
    live, live_gen = carry.state_to_numpy(dsvc.state), dsvc.gen
    dsvc.close()
    recs = oplog.read_log(wal_dir(str(tmp_path)))
    assert not recs or recs[0].gen_before > 0, "trim never dropped gen 0"
    rec = DurableService.open(str(tmp_path), device="cpu", snapshot_every=0)
    assert rec.gen == live_gen
    assert_arrays_equal(carry.state_to_numpy(rec.state), live)
    assert rec.stats()["restore_s"] > 0
    rec.close()


def test_open_without_a_card_raises_instead_of_a_fresh_store(tmp_path):
    """A store opened on the default device where there is no card raises;
    it never falls through to an empty store."""
    dsvc, _ = seed_store(tmp_path, n_chunks=2)
    dsvc.close()
    if torch.cuda.is_available():
        rec = DurableService.open(str(tmp_path), snapshot_every=0)
        assert rec.device.type == "cuda" and rec.gen == dsvc.gen
        rec.close()
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            DurableService.open(str(tmp_path), cfg=tiny_cfg(),
                                snapshot_every=0)
    assert checkpoint.latest_step(snap_dir(str(tmp_path))) == 0


# ------------------------------------------- reference helpers (module 1) --


def _helper_state():
    jcfg = jax_cfg()
    rng = np.random.default_rng(5)
    src = rng.integers(0, NV, 40).astype(np.int32)
    dst = rng.integers(0, NV, 40).astype(np.int32)
    js = jgs.from_arrays(jcfg, jnp.asarray(src), jnp.asarray(dst),
                         n_active_vertices=NV - 3)
    from repro.core import dynamic as jdynamic
    js = jdynamic.recompute(js, jcfg)
    return jcfg, js, carry.state_from_numpy(jax_arrays(js), "cpu")


def test_live_counts_and_communities_match_jax():
    _, js, ts = _helper_state()
    assert int(gs.live_edge_count(ts)) == int(jgs.live_edge_count(js))
    assert int(gs.live_vertex_count(ts)) == int(jgs.live_vertex_count(js))
    assert gs.live_edge_count(ts).dtype == torch.int32
    rep, size = community.largest_community(ts)
    jrep, jsize = jcommunity.largest_community(js)
    assert (int(rep), int(size)) == (int(jrep), int(jsize))
    users = np.asarray([0, 3, 5, NV - 1, NV - 2, 7, 3], np.int32)
    got = community.same_community_pairs(ts, torch.from_numpy(users))
    want = jcommunity.same_community_pairs(js, jnp.asarray(users))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("u,v", [(0, 5), (3, 3), (7, 20), (NV - 1, 0)])
def test_is_reachable_matches_jax(u, v):
    jcfg, js, ts = _helper_state()
    src, dst, live = gs.edge_coo(ts)
    got = reach.is_reachable(src, dst, live, u, v, ts.v_alive,
                             jcfg.max_inner)
    jsrc, jdst, jlive = jgs.edge_coo(js)
    want = jreach.is_reachable(jsrc, jdst, jlive, u, v, js.v_alive,
                               jcfg.max_inner)
    assert bool(got) == bool(want)


def test_service_gen_is_a_host_mirror_through_grows_and_replays():
    """The committed generation is a host int equal to the state's own
    counter after reactive grow-and-replay, compaction and a serial
    (pipeline-off) chunk."""
    for window in (8, 0):
        cfg = tiny_cfg(edge_capacity=16)
        svc = SCCService(cfg, state=gs.all_singletons(cfg, "cpu"),
                         buckets=(8,), inflight_window=window,
                         compact_tomb_frac=0.2)
        rng = np.random.default_rng(21)
        for _ in range(12):
            kind = np.where(rng.random(8) < 0.8, dynamic.ADD_EDGE,
                            dynamic.REM_EDGE).astype(np.int32)
            u = rng.integers(0, NV, 8).astype(np.int32)
            v = rng.integers(0, NV, 8).astype(np.int32)
            _, gen = svc._apply_ops(kind, u, v)
            assert isinstance(gen, int) and gen == int(svc.state.gen)
            assert svc.head[1] == gen and svc.head[0] is svc.state
        assert svc.stats()["grows"] > 0
