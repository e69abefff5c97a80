"""Hand-written CUDA kernels of the port, each beside its plain version.

Each wrapper counts its CUDA launches in a ``launches`` attribute (never a
plain-version call); :func:`launch_counts` reads them all, one count per
kernel source (hash_probe's three entries together).
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
    return {name: sum(fn.launches for fn in fns)
            for name, fns in _wrappers().items()}


def lane_launch_counts() -> dict:
    """Kernel name -> CUDA launches of the tenant-row forms so far (the
    kernels that have one)."""
    return {name: sum(fn.lane_launches for fn in fns)
            for name, fns in _wrappers().items()
            if hasattr(fns[0], "lane_launches")}


def reset_launch_counts() -> None:
    for fns in _wrappers().values():
        for fn in fns:
            fn.launches = 0
            if hasattr(fn, "lane_launches"):
                fn.lane_launches = 0
