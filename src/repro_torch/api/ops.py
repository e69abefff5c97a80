"""The typed op vocabulary of the public client API (a port of
``repro.api.ops``).

The paper models SMSCC as one *concurrent graph object*: a fixed pool of
threads issues AddEdge / RemoveEdge / AddVertex / RemoveVertex updates and
wait-free SameSCC / reachability / community queries against a single
coherent abstract object (arXiv:1804.01276; the interface-first framing is
arXiv:1710.08296).  This module is that object's request vocabulary: every
operation a client can issue is a small frozen dataclass, and the *only*
place the raw ``(kind, u, v)`` integer convention survives is the encoder
pair below, which packs homogeneous runs of typed ops into the compiled
core's :class:`repro_torch.core.dynamic.OpBatch` shapes (and back).  The compiled
engine is untouched; drivers stop re-inventing parallel-array encodings.

Vocabulary:

=====================  =========  ==========================================
op                     category   result value
=====================  =========  ==========================================
``AddEdge(u, v)``      update     ``bool`` — accepted (edge was absent)
``RemoveEdge(u, v)``   update     ``bool`` — accepted (edge was present)
``AddVertex(u)``       update     ``bool`` — accepted (vertex was absent)
``RemoveVertex(u)``    update     ``bool`` — accepted (vertex was present)
``SameSCC(u, v)``      query      ``bool`` — same strongly connected comp.
``Reachable(u, v)``    query      ``bool`` — u ⇝ v over live edges
``SccMembers(u)``      query      ``bool[NV]`` — u's SCC membership mask
``CommunityOf(u)``     query      ``int`` — community (SCC) id; the
                                  sentinel ``n_vertices`` when u is absent
``CommunitySizes()``   query      ``int32[NV]`` — community-size histogram
                                  indexed by representative id
=====================  =========  ==========================================
"""
from __future__ import annotations

import dataclasses
import operator
from typing import ClassVar, List, Sequence, Tuple

import numpy as np

from repro_torch.core import dynamic

__all__ = [
    "Op", "UpdateOp", "QueryOp",
    "AddEdge", "RemoveEdge", "AddVertex", "RemoveVertex",
    "SameSCC", "Reachable", "SccMembers", "CommunityOf", "CommunitySizes",
    "encode_updates", "updates_from_arrays",
]


@dataclasses.dataclass(frozen=True, slots=True)
class Op:
    """Base of every request the client API accepts."""


@dataclasses.dataclass(frozen=True, slots=True)
class UpdateOp(Op):
    """A graph mutation; routed to the SCCService update pipeline."""
    KIND: ClassVar[int]


@dataclasses.dataclass(frozen=True, slots=True)
class QueryOp(Op):
    """A read; routed to the QueryBroker against a committed snapshot."""
    BROKER_KIND: ClassVar[str]


# ------------------------------------------------------------- updates ---


@dataclasses.dataclass(frozen=True, slots=True)
class AddEdge(UpdateOp):
    u: int
    v: int
    KIND: ClassVar[int] = dynamic.ADD_EDGE


@dataclasses.dataclass(frozen=True, slots=True)
class RemoveEdge(UpdateOp):
    u: int
    v: int
    KIND: ClassVar[int] = dynamic.REM_EDGE


@dataclasses.dataclass(frozen=True, slots=True)
class AddVertex(UpdateOp):
    u: int
    KIND: ClassVar[int] = dynamic.ADD_VERTEX
    v: ClassVar[int] = 0  # lane placeholder: vertex ops carry no target


@dataclasses.dataclass(frozen=True, slots=True)
class RemoveVertex(UpdateOp):
    u: int
    KIND: ClassVar[int] = dynamic.REM_VERTEX
    v: ClassVar[int] = 0  # lane placeholder: vertex ops carry no target


# -------------------------------------------------------------- queries ---


@dataclasses.dataclass(frozen=True, slots=True)
class SameSCC(QueryOp):
    u: int
    v: int
    BROKER_KIND: ClassVar[str] = "same_scc"


@dataclasses.dataclass(frozen=True, slots=True)
class Reachable(QueryOp):
    u: int
    v: int
    BROKER_KIND: ClassVar[str] = "reachable"


@dataclasses.dataclass(frozen=True, slots=True)
class SccMembers(QueryOp):
    u: int
    BROKER_KIND: ClassVar[str] = "scc_members"


@dataclasses.dataclass(frozen=True, slots=True)
class CommunityOf(QueryOp):
    u: int
    BROKER_KIND: ClassVar[str] = "community_of"


@dataclasses.dataclass(frozen=True, slots=True)
class CommunitySizes(QueryOp):
    BROKER_KIND: ClassVar[str] = "community_sizes"


_KIND_TO_CLS = {
    dynamic.ADD_EDGE: AddEdge,
    dynamic.REM_EDGE: RemoveEdge,
    dynamic.ADD_VERTEX: AddVertex,
    dynamic.REM_VERTEX: RemoveVertex,
}
# the classes a run can be packed from without a per-op isinstance (exact
# types: a subclass splits the generic way)
UPDATE_CLASSES = frozenset(_KIND_TO_CLS.values())


# ------------------------------------------------------------- encoders ---


def encode_updates(ops: Sequence[UpdateOp]
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack a homogeneous run of update ops into ``(kind, u, v)`` arrays.

    The single sanctioned bridge from the typed vocabulary to the compiled
    core's lane convention (NOP padding stays an internal concern of the
    bucketed scheduler).  Vertex ops carry ``v = 0`` (ignored by the step).
    """
    n = len(ops)
    # every column is one C-level pass (an attrgetter into fromiter), no
    # Python frame an op
    try:
        # queries lack KIND and fail the encode, which is the type check
        kind = np.fromiter(map(operator.attrgetter("KIND"), ops), np.int32, n)
        u = np.fromiter(map(operator.attrgetter("u"), ops), np.int32, n)
        v = np.fromiter(map(operator.attrgetter("v"), ops), np.int32, n)
    except AttributeError as e:
        raise TypeError(f"encode_updates got a non-update op: {e}") from e
    return kind, u, v


def updates_from_arrays(kind, u, v) -> List[UpdateOp]:
    """Decode a legacy ``(kind, u, v)`` stream into typed update ops.

    The migration bridge for array-native generators
    (:func:`repro_torch.launch.workload.op_stream`): NOP lanes are dropped, every
    other lane becomes its dataclass.
    """
    kind = np.asarray(kind)
    u = np.asarray(u)
    v = np.asarray(v)
    out: List[UpdateOp] = []
    for k, uu, vv in zip(kind.tolist(), u.tolist(), v.tolist()):
        if k == dynamic.NOP:
            continue
        cls = _KIND_TO_CLS[k]
        if cls in (AddEdge, RemoveEdge):
            out.append(cls(uu, vv))
        else:
            out.append(cls(uu))
    return out
