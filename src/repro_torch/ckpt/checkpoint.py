"""Step-fenced atomic checkpointing (npz), a port of
``repro.ckpt.checkpoint``.

Write protocol (crash-safe at every point):
  1. serialize the flattened tree to ``ckpt_<step>.npz.tmp``;
  2. fsync + rename to ``ckpt_<step>.npz``  (atomic on POSIX);
  3. rewrite ``LATEST`` (tiny file: step + payload checksum) via the same
     tmp+rename dance.

A reader never observes a torn checkpoint: either LATEST points to a fully
renamed npz whose checksum matches, or restore falls back to the previous
one.  ``keep`` bounds disk usage.

The tree is flattened to the key paths ``jax.tree_util`` gives the JAX
package -- ``d:<key>`` for a dict key (keys sorted), ``a:<field>`` for a
NamedTuple field, ``s:<idx>`` for a list or tuple index, joined by ``|``
-- so a store written by either package opens in the other.  Leaves may
be torch tensors (copied to the host here, so a background writer pays
the device-to-host copy, not its caller) or numpy arrays; a bf16 tensor
is stored as its bits (``BF16_KEYS``).
"""
from __future__ import annotations

import hashlib
import json
import os
import re
from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.core import edge_table as et
from repro_torch.core import graph_state as gs
from repro_torch.fault.inject import fs_fsync, fs_open
from repro_torch.tree import SEP as _SEP, is_namedtuple, leaves

# A bf16 leaf (numpy has no bf16) is stored as its uint16 bits under its
# own key path, and its key listed in this entry; every other leaf is
# stored as it is, so a store without bf16 leaves is unchanged.
BF16_KEYS = "__bf16__"


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(np.uint16)
        return t.cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree) -> dict:
    flat, bf16 = {}, []
    for key, leaf in leaves(tree):
        flat[key] = _host(leaf)
        if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
            bf16.append(key)
    if bf16:
        flat[BF16_KEYS] = np.array(bf16)
    return flat


def _rebuild(like, data, path: Tuple[str, ...] = (),
             bf16: frozenset = frozenset()):
    """``like``'s structure with every leaf read from ``data`` and cast to
    the leaf's dtype (a torch leaf comes back on its own device); the keys
    in ``bf16`` hold bf16 bits."""
    if isinstance(like, dict):
        return {k: _rebuild(like[k], data, path + (f"d:{k}",), bf16)
                for k in like}
    if is_namedtuple(like):
        return type(like)(*(_rebuild(getattr(like, n), data,
                                     path + (f"a:{n}",), bf16)
                            for n in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(x, data, path + (f"s:{i}",), bf16)
                          for i, x in enumerate(like))
    if like is None:
        return None
    key = _SEP.join(path)
    arr = data[key]
    if key in bf16:
        t = torch.from_numpy(np.array(arr).view(np.int16)).view(
            torch.bfloat16)
        if isinstance(like, torch.Tensor):
            return t.to(device=like.device, dtype=like.dtype)
        arr = t.float().numpy()
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(device=like.device,
                                                  dtype=like.dtype)
    return np.asarray(arr, like.dtype) if hasattr(like, "dtype") else arr


def save(directory: str, step: int, tree: Any, keep: int = 3) -> str:
    os.makedirs(directory, exist_ok=True)
    flat = _flatten(tree)
    path = os.path.join(directory, f"ckpt_{step}.npz")
    tmp = path + ".tmp"
    with fs_open(tmp, "wb") as f:
        np.savez(f, **flat)
        f.flush()
        fs_fsync(f)
    os.rename(tmp, path)
    digest = _digest(path)
    latest = os.path.join(directory, "LATEST")
    ltmp = latest + ".tmp"
    with fs_open(ltmp, "w") as f:
        json.dump({"step": step, "file": os.path.basename(path),
                   "sha256": digest}, f)
        f.flush()
        fs_fsync(f)
    os.rename(ltmp, latest)
    _gc(directory, keep)
    return path


def _digest(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _steps(directory: str) -> list:
    """On-disk checkpoint steps, ascending."""
    return sorted(int(re.findall(r"\d+", f)[0])
                  for f in os.listdir(directory)
                  if re.fullmatch(r"ckpt_\d+\.npz", f))


def _gc(directory: str, keep: int):
    for s in _steps(directory)[:-keep]:
        os.remove(os.path.join(directory, f"ckpt_{s}.npz"))


def latest_step(directory: str) -> int | None:
    latest = os.path.join(directory, "LATEST")
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        meta = json.load(f)
    path = os.path.join(directory, meta["file"])
    if not os.path.exists(path) or _digest(path) != meta["sha256"]:
        # torn LATEST (crash between npz rename and LATEST rewrite, or
        # corruption): fall back to newest intact file
        steps = _steps(directory)
        return steps[-1] if steps else None
    return meta["step"]


def restore(directory: str, tree_like: Any, step: int | None = None):
    """Restore into the structure of ``tree_like``.  Returns (tree, step)
    or (None, None) when no checkpoint exists."""
    if step is None:
        step = latest_step(directory)
    if step is None:
        return None, None
    with np.load(os.path.join(directory, f"ckpt_{step}.npz")) as data:
        bf16 = frozenset(data[BF16_KEYS].tolist()) \
            if BF16_KEYS in data.files else frozenset()
        return _rebuild(tree_like, data, bf16=bf16), step


# ------------------------------------------------- graph snapshots ------
# A graph snapshot is an ordinary step-fenced checkpoint whose step IS the
# committed generation, carrying the GraphState plus a JSON meta leaf that
# records everything recovery needs to resume a bit-identical run: the
# GraphConfig fields (edge_capacity changes under growth) and the service
# knobs that steer growth/compaction decisions.


def _graph_template() -> gs.GraphState:
    """A dtype-correct numpy GraphState skeleton for ``restore`` (shapes
    come from the file; only dtypes matter here)."""
    z32 = np.zeros((), np.int32)
    return gs.GraphState(
        v_alive=np.zeros((), bool), ccid=z32,
        edges=et.EdgeTable(src=z32, dst=z32, state=np.zeros((), np.int8)),
        n_ccs=z32, gen=z32, overflow=z32)


def save_graph_snapshot(directory: str, state, meta: dict,
                        keep: int = 3) -> str:
    """Checkpoint a committed GraphState at generation ``meta['gen']``.

    ``meta`` must carry ``gen``, a ``cfg`` dict of GraphConfig fields,
    and a ``service`` dict of decision-relevant service knobs."""
    if not {"gen", "cfg", "service"} <= meta.keys():
        raise ValueError(f"snapshot meta lacks gen/cfg/service: {meta}")
    blob = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    return save(directory, int(meta["gen"]), {"graph": state, "meta": blob},
                keep)


def load_graph_meta(directory: str, step: int | None = None):
    """(meta dict, step) of a graph snapshot, or (None, None)."""
    if step is None:
        step = latest_step(directory)
    if step is None:
        return None, None
    with np.load(os.path.join(directory, f"ckpt_{step}.npz")) as data:
        key = next(k for k in data.files if k.endswith("meta"))
        return json.loads(bytes(bytearray(data[key]))), step


def _candidate_steps(directory: str) -> list:
    """Snapshot steps to try, newest first: LATEST's pick, then every
    on-disk step in descending order (recovery falls through corrupt or
    unreadable newer snapshots to older intact ones)."""
    if not os.path.isdir(directory):
        return []
    steps = _steps(directory)[::-1]
    head = latest_step(directory)
    if head is not None and head in steps:
        steps.remove(head)
        steps.insert(0, head)
    return steps


def _read_graph_snapshot(directory: str, step: int):
    """(numpy GraphState, cfg, meta, step), or None when absent."""
    meta, step = load_graph_meta(directory, step)
    if meta is None:
        return None
    cfg = gs.GraphConfig(**{**meta["cfg"], "region_edge_buckets":
                            tuple(meta["cfg"]["region_edge_buckets"])})
    tree, _ = restore(directory, {"graph": _graph_template(),
                                  "meta": np.zeros((), np.uint8)}, step)
    return tree["graph"], cfg, meta, step


def restore_graph_snapshot(directory: str, step: int | None = None,
                           device=gs.DEFAULT_DEVICE):
    """Restore ``(state, cfg, meta, step)`` from the latest (or given)
    graph snapshot onto ``device``; ``(None, None, None, None)`` when none
    exists.

    Without an explicit ``step``, an unreadable newest snapshot (torn
    npz payload, dangling LATEST) is skipped in favour of the next
    older one -- the WAL tail replay covers the difference.  Only reading
    the files may fall back: a failure to place the state on ``device``
    (no card) raises."""
    candidates = [step] if step is not None else \
        _candidate_steps(directory)
    for s in candidates:
        try:
            got = _read_graph_snapshot(directory, s)
        except Exception:
            if step is not None:
                raise  # an explicitly requested step must not degrade
            continue
        if got is None:
            continue
        host, cfg, meta, s = got
        state = type(host)(*(
            et.EdgeTable(*(torch.from_numpy(a).to(device) for a in leaf))
            if isinstance(leaf, et.EdgeTable)
            else torch.from_numpy(leaf).to(device) for leaf in host))
        return state, cfg, meta, s
    return None, None, None, None
