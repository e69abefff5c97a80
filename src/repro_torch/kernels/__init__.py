"""Hand-written CUDA kernels of the port, each beside its plain version.

Each wrapper counts its CUDA launches in a ``launches`` attribute (never a
plain-version call); :func:`launch_counts` reads them all.
"""


def _wrappers() -> dict:
    from repro_torch.kernels.frontier_expand import ops as fops
    from repro_torch.kernels.hash_probe import ops as hops
    from repro_torch.kernels.reach_blockmm import ops as bops
    return {"frontier_min": fops.frontier_min, "hash_probe": hops.probe,
            "bool_matmul": bops.bool_matmul}


def launch_counts() -> dict:
    """Kernel name -> CUDA launches so far."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
