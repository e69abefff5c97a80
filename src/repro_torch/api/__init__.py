# The port's client surface: typed ops (AddEdge, SameSCC, ...) submitted
# through a GraphClient over the SCCService update pipeline and the
# QueryBroker reader path.
from repro_torch.api.client import (  # noqa: F401
    AtLeast,
    Consistency,
    GraphClient,
    Result,
)
from repro_torch.api.ops import (  # noqa: F401
    AddEdge,
    AddVertex,
    CommunityOf,
    CommunitySizes,
    Op,
    QueryOp,
    Reachable,
    RemoveEdge,
    RemoveVertex,
    SameSCC,
    SccMembers,
    UpdateOp,
    encode_updates,
    updates_from_arrays,
)
