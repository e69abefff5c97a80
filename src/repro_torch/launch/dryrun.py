"""Multi-pod dry-run of the port: every (arch x shape x mesh) cell built
and run once on fake tensors, as ``repro.launch.dryrun`` lowers and
compiles each on 512 fake XLA host devices.

For each cell the dry-run:
  1. starts a fake process group of 256 or 512 ranks in this one process
     (backend "fake") and builds the production mesh on device type
     "cpu";
  2. builds the sharded step (``launch/steps.py``), and under
     FakeTensorMode turns its args into DTensors with the bundle's
     placements (each rank's shard; nothing is allocated) and runs ``fn``
     once, with ``mesh.sharded_ops`` doing what GSPMD does for an op that
     DTensor cannot partition;
  3. meters rank 0's share: FLOPs (``FlopCounterMode``'s formulas, each
     local aten op), bytes accessed (each local aten op's inputs and
     outputs: counted before fusion, so above what fused kernels move),
     collectives by kind with their bytes (the larger of input and
     output, as the reference reads its HLO; ``CommDebugMode`` counts
     them too), memory (argument, output and peak live bytes of fake
     tensors);
  4. derives the three roofline terms from an H100's data-sheet figures
     (estimates, not measurements) and appends one JSON record.

Metering: an eager fake run executes every layer and every edge chunk,
so no unrolled or unchunked twin is needed (the reference needs them
because XLA counts a while body once).  An SMSCC update step reads the
host every fixpoint round, which a fake tensor cannot answer, so its
cell meters one round: one frontier_gather round over the sharded edge
table with the all-reduce-min merge of the replicated labels, and one
probe sweep of the op batch; multiply by measured rounds.

Usage:
  python -m repro_torch.launch.dryrun --arch smscc --shape update_1m
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out f.jsonl]
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import time
import traceback

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch import configs as cfg_registry
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.tree import tree_leaves, tree_map

# NVIDIA H100 SXM data sheet (dense rates), not measurements
PEAK_FLOPS = 989e12          # bf16 FLOP/s a GPU
HBM_BW = 3.35e12             # bytes/s a GPU
NVLINK_BW = 450e9            # bytes/s a direction, within a node of 8
IB_BW = 50e9                 # bytes/s a GPU across nodes (InfiniBand NDR)
NODE = 8                     # GPUs a node

# DTensor's functional collectives -> the reference's kinds
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_COLLECTIVE_NS = ("_c10d_functional", "c10d_functional")
# ops that move no bytes
_FREE = {"detach", "alias", "device", "empty", "empty_strided",
         "empty_like", "lift_fresh"}


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _group_ranks(args) -> tuple:
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in reversed(args):
        if isinstance(a, str):
            try:
                return tuple(dist.get_process_group_ranks(
                    _resolve_process_group(a)))
            except (ValueError, RuntimeError, KeyError):
                return ()
    return ()


def link_bw(ranks) -> float:
    """NVLink for a group inside one node of 8, InfiniBand otherwise."""
    if ranks and max(ranks) // NODE == min(ranks) // NODE:
        return NVLINK_BW
    return IB_BW


class Meter(TorchDispatchMode):
    """Rank 0's local aten ops (DTensor ops pass through to their local
    form): FLOPs through ``FlopCounterMode``'s formulas, bytes accessed,
    collectives by kind (``collectives``: bytes and ``count_<kind>``;
    ``collective_s``: their seconds at each group's link rate), and the
    peak of live storage bytes, starting from ``live0``."""

    def __init__(self, live0: int = 0):
        from torch.utils.flop_counter import FlopCounterMode
        super().__init__()
        self.flop_counter = FlopCounterMode(display=False)
        self.bytes_accessed = 0
        self.collectives = collections.Counter()
        self.collective_s = 0.0
        self.live0 = live0
        self.peak = live0
        self._storages = {}
        self._in_prop = 0
        self._ops = 0
        self._prop = None

    @property
    def flops(self) -> int:
        return self.flop_counter.get_total_flops()

    def __enter__(self):
        # DTensor runs each new op once on fake global-shape stand-ins to
        # infer its output: not rank 0's work, so not counted
        from torch.distributed.tensor._sharding_prop import (
            ShardingPropagator)
        orig = ShardingPropagator._propagate_tensor_meta_non_cached
        meter = self

        def propagate(prop, op_schema):
            meter._in_prop += 1
            try:
                return orig(prop, op_schema)
            finally:
                meter._in_prop -= 1

        self._prop = (ShardingPropagator, orig)
        ShardingPropagator._propagate_tensor_meta_non_cached = propagate
        return super().__enter__()

    def __exit__(self, *exc):
        cls, orig = self._prop
        cls._propagate_tensor_meta_non_cached = orig
        self._sweep()
        return super().__exit__(*exc)

    def _sweep(self):
        self._storages = {k: v for k, v in self._storages.items()
                          if not v[0].expired()}
        self.peak = max(self.peak, self.live0 + sum(
            n for _, n in self._storages.values()))

    def _track(self, outs):
        from torch.multiprocessing.reductions import StorageWeakRef
        for t in outs:
            st = t.untyped_storage()
            ref = StorageWeakRef(st)
            if ref.cdata not in self._storages:
                self._storages[ref.cdata] = (ref, st.nbytes())
        self._ops += 1
        if self._ops % 16 == 0:
            self._sweep()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._in_prop:
            return out
        packet = func._overloadpacket
        name = packet.__name__.rstrip("_")
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if func.namespace in _COLLECTIVE_NS:
            kind = COLLECTIVE_KINDS.get(name)
            if kind is not None:
                b = max(_nbytes(ins), _nbytes(outs))
                self.collectives[kind] += b
                self.collectives["count_" + kind] += 1
                self.collective_s += b / link_bw(_group_ranks(args))
            return out
        self.flop_counter._count_flops(packet, out, args, kwargs)
        if not func.is_view and name not in _FREE:
            self.bytes_accessed += _nbytes(ins) + _nbytes(outs)
        self._track(outs)
        return out


def _memo(fn, wrap=contextlib.nullcontext):
    answers = {}

    def memo(*args, **kwargs):
        key = (args, tuple(sorted(kwargs.items())))
        if key not in answers:
            with wrap():
                answers[key] = fn(*args, **kwargs)
        return answers[key]
    return memo


@contextlib.contextmanager
def _dtensor_planning():
    """Two fixes to DTensor's planning for fake runs, both pure functions
    of their (hashable) arguments, answered once each:
    * a strided shard (a flatten of a dim sharded over 'pod' and 'data')
      is sized by splitting an ``arange``, which FakeTensorMode turns into
      a fake tensor it cannot read back: size it on real tensors;
    * the redistribute planner, asked for the cost of every candidate
      strategy of every op, searches a graph of placements each time:
      on a 3-d mesh that search dominated a run (minutes a layer)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import _redistribute
    from torch.distributed.tensor.placement_types import _StridedShard
    saved = [(_StridedShard, "local_shard_size_and_offset"),
             (_redistribute, "_gen_transform_infos")]
    origs = [getattr(o, n) for o, n in saved]
    _StridedShard.local_shard_size_and_offset = _memo(
        origs[0], unset_fake_temporarily)
    _redistribute._gen_transform_infos = _memo(origs[1])
    try:
        yield
    finally:
        for (o, n), f in zip(saved, origs):
            setattr(o, n, f)


def fake_process_group(world_size: int):
    """A fake process group of ``world_size`` ranks in this process
    (rank 0), replacing any earlier one."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", rank=0, world_size=world_size,
                            store=FakeStore())


def _local_shapes(args, specs, mesh):
    """Each tensor arg's (global shape, local shape, placements), computed
    outside fake mode."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    def one(t, spec):
        if not isinstance(t, torch.Tensor):
            return None
        pl = mesh_lib.placements(spec, mesh)
        local, _ = compute_local_shape_and_global_offset(t.shape, mesh, pl)
        return (tuple(t.shape), tuple(local), pl)
    return tree_map(one, args, specs)


def _shard(args, shapes, mesh):
    """Fake DTensors of ``args`` (inside FakeTensorMode): rank 0's shard
    of each, laid out by its placements."""
    from torch.distributed.tensor import DTensor

    def one(t, s):
        if s is None:
            return t
        full, local, pl = s
        return DTensor.from_local(
            torch.empty(local, dtype=t.dtype), mesh, pl, run_check=False,
            shape=torch.Size(full),
            stride=torch.empty(full, device="meta").stride())
    return tree_map(one, args, shapes)


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    from torch.multiprocessing.reductions import StorageWeakRef
    seen, n = set(), 0
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            key = StorageWeakRef(t.untyped_storage()).cdata
            if key not in seen:
                seen.add(key)
                n += t.untyped_storage().nbytes()
    return n


# ------------------------------------------------------- SMSCC metering ---

def _dp_placements(mesh, dp_placement):
    from torch.distributed.tensor import Replicate
    return [dp_placement if a in mesh_lib.data_axes(mesh) else Replicate()
            for a in mesh_lib.axis_names(mesh)]


def _merge(x, mesh, reduce_op: str):
    """Each data-parallel rank's partial ``x`` reduced over the data axes
    (an all-reduce), replicated."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    part = DTensor.from_local(x, mesh, _dp_placements(
        mesh, Partial(reduce_op)), run_check=False)
    return part.redistribute(mesh, [Replicate()] * mesh.ndim)


def smscc_round(state, ops, mesh):
    """One fixpoint round of the update step on the sharded state (rank
    0's share): a label round over this rank's edge-table columns (the
    frontier_gather kernel's plain form), merged by an all-reduce-min of
    the replicated labels; then one probe sweep of the op batch, every
    lane against this rank's columns, merged by an all-reduce-max."""
    from repro_torch.core import reach
    from repro_torch.core.edge_table import EMPTY, LIVE
    from repro_torch.kernels.hash_probe import ref as href
    src = state.edges.src.to_local()
    dst = state.edges.dst.to_local()
    st = state.edges.state.to_local()
    allowed = state.v_alive.to_local()
    lab, _ = reach.label_round(src, dst, st == LIVE, allowed,
                               state.ccid.to_local())
    labels = _merge(lab, mesh, "min")
    # probe sweep: this rank owns columns [0, C_local) of the table
    u, v = ops.u.full_tensor(), ops.v.full_tensor()
    pos = href.hash_slots(u, v, state.edges.src.shape[0])
    mine = pos < src.shape[0]
    at = torch.where(mine, pos, 0).long()
    hit = mine & (st[at] == LIVE) & (src[at] == u) & (dst[at] == v)
    empty = mine & (st[at] == EMPTY)
    flags = _merge(torch.stack([hit, empty]).to(torch.int32), mesh, "max")
    return labels, flags


# ------------------------------------------------------------------ cell ---

def run_cell(arch: str, shape_name: str, multi_pod: bool, lm_layers=None,
             overrides=None, tag: str = "baseline") -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.debug import CommDebugMode
    fake_process_group(512 if multi_pod else 256)
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                         device_type="cpu")
    n_ranks = mesh.size()
    bundle = steps_lib.build(arch, shape_name, mesh, lm_layers=lm_layers,
                             overrides=overrides)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "x".join(str(s) for s in mesh.shape),
           "chips": int(n_ranks), "tag": tag,
           "overrides": {k: str(v) for k, v in (overrides or {}).items()}}
    if lm_layers is not None:
        rec["lm_layers"] = lm_layers
    if bundle is None:
        rec["status"] = "skipped"
        rec["reason"] = cfg_registry.get(arch).SHAPES[shape_name]["skip"]
        return rec

    fam = cfg_registry.get(arch).FAMILY
    shapes = _local_shapes(bundle.args, bundle.in_shardings, mesh)
    t0 = time.perf_counter()
    with FakeTensorMode(), _dtensor_planning():
        args = _shard(bundle.args, shapes, mesh)
        arg_bytes = _local_bytes(args)
        meter = Meter(live0=arg_bytes)
        comm = CommDebugMode()
        with mesh_lib.sharded_ops(mesh) as ops, comm, meter:
            if fam == "smscc" and bundle.meta.get("flops_unit"):
                out = smscc_round(*args, mesh)
            else:
                out = bundle.fn(*args)
        out_bytes = _local_bytes(out)
        del out
    rec["status"] = "ok"
    rec["run_s"] = time.perf_counter() - t0
    rec["memory"] = {"argument_size_in_bytes": arg_bytes,
                     "output_size_in_bytes": out_bytes,
                     "peak_live_bytes": meter.peak}
    rec["cost"] = {"flops": float(meter.flops),
                   "bytes accessed": float(meter.bytes_accessed),
                   "bytes_note": "each aten op's inputs and outputs, "
                                 "before fusion"}
    rec["collectives"] = dict(meter.collectives)
    rec["comm_counts"] = {str(k): v for k, v in
                          comm.get_comm_counts().items()}
    rec["replicated_ops"] = dict(ops.replicated)
    if fam == "smscc" and bundle.meta.get("flops_unit"):
        rec["metering"] = ("one fixpoint round (a frontier_gather round "
                           "over the sharded edge table, an all-reduce-min "
                           "of the labels) and one probe sweep; multiply "
                           "by measured rounds")
    else:
        rec["metering"] = ("eager fake run: every layer and edge chunk "
                           "executed and counted; no twins")

    flops, mem_bytes = meter.flops, meter.bytes_accessed
    model_flops = bundle.meta.get("model_flops", 0)
    rec["meta"] = dict(bundle.meta)
    rec["roofline"] = {
        "constants": "H100 SXM data sheet: 989e12 bf16 FLOP/s, 3.35e12 "
                     "HBM B/s, 450e9 NVLink B/s in a node of 8, 50e9 IB "
                     "B/s across nodes (estimates)",
        "compute_s": flops / PEAK_FLOPS,
        "memory_s": mem_bytes / HBM_BW,
        "collective_s": meter.collective_s,
        "model_flops_total": model_flops,
        "flops_per_chip": flops,
        "useful_ratio": (model_flops / n_ranks) / flops if flops else None,
    }
    terms = {k: rec["roofline"][k] for k in
             ("compute_s", "memory_s", "collective_s")}
    rec["roofline"]["bottleneck"] = max(terms, key=terms.get)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="dryrun_results.jsonl")
    args = ap.parse_args()
    torch.set_num_threads(1)

    if args.all:
        cells = [(arch, shape) for arch in cfg_registry.all_archs()
                 for shape in cfg_registry.get(arch).SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        raise SystemExit("give --arch and --shape, or --all")

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    done = set()
    try:
        with open(args.out) as f:
            for line in f:
                r = json.loads(line)
                if r.get("status") in ("ok", "skipped"):
                    done.add((r["arch"], r["shape"], r["mesh"]))
    except FileNotFoundError:
        pass

    for arch, shape in cells:
        for mp in meshes:
            mesh_name = "2x16x16" if mp else "16x16"
            if (arch, shape, mesh_name) in done:
                print(f"[dryrun] skip cached {arch}:{shape}:{mesh_name}")
                continue
            print(f"[dryrun] {arch}:{shape} mesh={mesh_name} ...",
                  flush=True)
            try:
                rec = run_cell(arch, shape, mp)
            except Exception as e:  # a cell's failure is its record
                rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                       "status": "error", "error": str(e),
                       "trace": traceback.format_exc()[-2000:]}
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
            print(f"[dryrun]   -> {rec['status']} "
                  f"run={rec.get('run_s', '-')}s bottleneck="
                  f"{rec.get('roofline', {}).get('bottleneck', '-')}",
                  flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
