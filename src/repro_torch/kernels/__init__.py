"""Hand-written CUDA kernels of the port, each beside its plain version.

Each wrapper counts its CUDA launches in a ``launches`` attribute (never a
plain-version call); :func:`launch_counts` reads them all, one count per
kernel source (hash_probe's three entries together).  Launches made by
replays of the SMSCC step graph are added in first
(``_build.flush_graph_launches``: one read of each graph's counters).
"""


def _wrappers() -> dict:
    from repro_torch.kernels.frontier_expand import ops as fops
    from repro_torch.kernels.hash_probe import ops as hops
    from repro_torch.kernels.reach_blockmm import ops as bops
    from repro_torch.kernels.flash_attention import ops as aops
    from repro_torch.kernels.embedding_bag import ops as eops
    return {"frontier_min": (fops.frontier_min,),
            "hash_probe": (hops.probe, hops.insert, hops.remove),
            "bool_matmul": (bops.bool_matmul,),
            "flash_attention": (aops.mha,),
            "embedding_bag": (eops.embedding_bag,)}


def launch_counts() -> dict:
    """Kernel name -> CUDA launches so far."""
    from repro_torch.kernels import _build
    _build.flush_graph_launches()
    return {name: sum(fn.launches for fn in fns)
            for name, fns in _wrappers().items()}


def lane_launch_counts() -> dict:
    """Kernel name -> CUDA launches of the tenant-row forms so far (the
    kernels that have one)."""
    from repro_torch.kernels import _build
    _build.flush_graph_launches()
    return {name: sum(fn.lane_launches for fn in fns)
            for name, fns in _wrappers().items()
            if hasattr(fns[0], "lane_launches")}


def reset_launch_counts() -> None:
    """Every launch count to 0, and the fixpoint launches' round counters
    on the card (``frontier_expand.ops.fixpoint_rounds``)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.frontier_expand import ops as fops
    _build.flush_graph_launches()
    for fns in _wrappers().values():
        for fn in fns:
            fn.launches = 0
            for attr in ("lane_launches", "fixpoint_launches",
                         "scc_launches"):
                if hasattr(fn, attr):
                    setattr(fn, attr, 0)
    fops.reset_fixpoint_rounds()
