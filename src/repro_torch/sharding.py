"""The port's sharding vocabulary: the counterpart of ``jax.sharding``
and ``jax.lax.with_sharding_constraint`` in DTensor terms.  Imports
nothing of the port, so the core and the models use it below the launch
layer (``launch/mesh.py`` builds the meshes and re-exports these names).

* ``P``: a PartitionSpec, one entry per tensor dim naming a mesh axis, a
  tuple of axes (split major to minor) or None;
* ``placements(spec, mesh)``: the DTensor placements of a spec;
* ``use_mesh(mesh)``: the reference's ``with mesh:`` (``current_mesh``);
* ``constrain(x, spec)``: ``jax.lax.with_sharding_constraint``;
* ``unshard_dim(x, dim)``: one dim on no mesh axis;
* ``axis_names`` / ``axis_size``: read a DeviceMesh or any mesh-like
  object with ``axis_names`` and a ``shape`` dict (the reference's tests'
  FakeMesh), so the spec builders run on either;
* ``sharded_ops(mesh)``: what GSPMD does for an op it cannot partition,
  for DTensor runs: plain tensors meeting a DTensor join it replicated,
  and an op with no DTensor sharding rule runs on replicated operands;
* ``remat_context``: re-enters ``sharded_ops`` in a remat's recompute.

On a plain ``torch.Tensor`` (every single-device path) ``constrain`` and
``unshard_dim`` return at their first test: no import, no mesh lookup
unless a spec is set.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import math

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_flatten, tree_map

_CURRENT = contextvars.ContextVar("repro_torch_mesh", default=None)
_SHARDED = contextvars.ContextVar("repro_torch_sharded_ops", default=None)


class P:
    """The port's PartitionSpec: ``P("data", None)``, ``P(("data",
    "model"))``, ``P()`` (replicated).  A leaf of the port's trees (not a
    tuple, which ``repro_torch.tree`` would walk into)."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        return isinstance(other, P) and self.entries == other.entries

    def __hash__(self):
        return hash(("P",) + self.entries)

    def __repr__(self):
        return f"P{self.entries!r}"


def lead(spec):
    """``spec`` behind one leading unsharded dim (None stays None)."""
    return None if spec is None else P(None, *spec)


def axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_size(mesh, name: str) -> int:
    shape = mesh.shape
    if isinstance(shape, dict):
        return int(shape[name])
    return int(shape[axis_names(mesh).index(name)])


def mesh_size(mesh) -> int:
    return math.prod(axis_size(mesh, a) for a in axis_names(mesh))


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` current (the reference's ``with mesh:``)."""
    token = _CURRENT.set(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.reset(token)


def current_mesh():
    return _CURRENT.get()


# ------------------------------------------------------------- shardings ---

def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` over ``mesh``: ``Shard(d)`` on each
    mesh dim that tensor dim d names, ``Replicate()`` on the rest.  A dim
    named by two axes is split over both, the first the major one, as
    JAX splits it; so the axes must come in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: dim {d} names {axes} out of the "
                             f"mesh's order {names}")
        for i in idx:
            if isinstance(out[i], Shard):
                raise ValueError(f"{spec}: axis {names[i]!r} named twice")
            out[i] = Shard(d)
    return tuple(out)


def distribute(x: torch.Tensor, spec, mesh):
    """``x`` (the same full value on every rank) as a DTensor laid out by
    ``spec``: each rank keeps its own shard, no communication."""
    from torch.distributed.tensor import DTensor, Replicate
    rep = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
    return rep.redistribute(mesh, placements(spec, mesh))


def unshard_dim(x, dim: int):
    """``x`` with tensor dim ``dim`` on no mesh axis (its gradient laid out
    back as ``x`` is): a split of that dim into parts that need not divide
    a mesh axis (40 heads over 16 ranks) then partitions.  The identity
    on a plain tensor."""
    if type(x) is torch.Tensor:
        return x
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    dim = dim % x.dim()
    want = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
            for p in x.placements]
    return x.redistribute(x.device_mesh, want)


def constrain(x, spec):
    """The counterpart of ``jax.lax.with_sharding_constraint``; the values
    never change.  A DTensor is redistributed to ``spec``; a plain tensor
    passes through where no mesh is current or the mesh has one rank, and
    raises under a mesh of more ranks (one rank's tensor is not the
    mesh's)."""
    if spec is None:
        return x
    if type(x) is not torch.Tensor:
        from torch.distributed.tensor import DTensor
        if isinstance(x, DTensor):
            want = placements(spec, x.device_mesh)
            if tuple(x.placements) == want:
                return x
            return x.redistribute(x.device_mesh, want)
    mesh = current_mesh()
    if mesh is None or mesh_size(mesh) == 1:
        return x
    raise ValueError(
        f"constrain to {spec}: a plain tensor under a mesh of "
        f"{mesh_size(mesh)} ranks; distribute it first")


# whole backward passes: their ops run below this mode, never replicated
# as one call
_AUTOGRAD = (torch.autograd.grad, torch.autograd.backward,
             torch.Tensor.backward)


class sharded_ops(TorchFunctionMode):
    """Run DTensor code over ``mesh`` where DTensor lacks a rule, as GSPMD
    does where it cannot partition an op: a plain tensor meeting a
    DTensor joins it replicated (an ``arange``, a scalar), and an op that
    has no sharding strategy runs on replicated operands, its result
    replicated.  ``replicated`` counts those ops by name; the collective
    count shows what they cost.  Also makes ``mesh`` current."""

    def __init__(self, mesh):
        super().__init__()
        self.mesh = mesh
        self.replicated = collections.Counter()
        self._ctx = None

    def __enter__(self):
        from torch.distributed.tensor.experimental import (
            implicit_replication)
        self._ctx = contextlib.ExitStack()
        self._ctx.enter_context(use_mesh(self.mesh))
        token = _SHARDED.set(self)
        self._ctx.callback(_SHARDED.reset, token)
        # a plain tensor meeting a DTensor, also inside the backward
        # (where this mode is off), joins it replicated
        self._ctx.enter_context(implicit_replication())
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._ctx.close()

    def again(self) -> "sharded_ops":
        """A fresh entry of this mode (same mesh and counts)."""
        mode = sharded_ops(self.mesh)
        mode.replicated = self.replicated
        return mode

    def __torch_function__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor, Replicate
        kwargs = kwargs or {}
        flat, _ = tree_flatten((args, kwargs))
        if func in _AUTOGRAD or not any(isinstance(a, DTensor)
                                        for a in flat):
            return func(*args, **kwargs)
        try:
            return func(*args, **kwargs)
        except NotImplementedError:
            pass
        except RuntimeError as e:  # e.g. heads that do not divide a shard
            if "Sharding propagation failed" not in str(e):
                raise
        self.replicated[getattr(func, "__name__", str(func))] += 1
        rep = [Replicate()] * self.mesh.ndim
        first = next(a for a in flat if isinstance(a, DTensor))

        def local(a):
            if isinstance(a, DTensor):
                return a.redistribute(self.mesh, rep).to_local()
            return a

        def reshard(o):
            if not isinstance(o, torch.Tensor):
                return o
            out = DTensor.from_local(o, self.mesh, rep, run_check=False)
            return out.redistribute(self.mesh, self._like(first, o))

        out = func(*tree_map(local, args), **tree_map(local, kwargs))
        return tree_map(reshard, out)

    def _like(self, first, o) -> list:
        """``first``'s placements where ``o`` keeps the sharded dim's size
        (and the mesh dim divides it), Replicate elsewhere: a local slice
        of the replicated result."""
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for i, p in enumerate(first.placements):
            keep = (isinstance(p, Shard) and p.dim < o.dim()
                    and o.shape[p.dim] == first.shape[p.dim]
                    and o.shape[p.dim] % self.mesh.size(i) == 0)
            out.append(p if keep else Replicate())
        return out


def remat_context(inner=None):
    """``context_fn`` of ``torch.utils.checkpoint``: a remat's recompute
    runs inside the backward pass, below an active ``sharded_ops``, so
    it re-enters that mode there.  ``inner`` is another context_fn (a
    selective policy's) to compose with."""
    fwd, rec = inner() if inner is not None else (contextlib.nullcontext(),
                                                  contextlib.nullcontext())
    mode = _SHARDED.get()
    if mode is None:
        return fwd, rec
    return fwd, _both(rec, mode.again())


@contextlib.contextmanager
def _both(first, second):
    with first, second:
        yield
