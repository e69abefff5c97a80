"""Each cell cut to a size the CPU steps in a fraction of a second: the
configuration's own settings, 512 vertices, the mixes' own shape."""
import torch

from bench import harness


def config(name: str = "smscc-1m") -> dict:
    cfg = harness.config_of(harness.load_spec(), name)
    cfg.update(n_vertices=512, edge_capacity=4096, bucket=64)
    cfg["engine"]["region_vertex_capacity"] = 64
    return cfg


def mix(traffic: str) -> dict:
    m = harness.mix_of(traffic)
    m.update(chunk_ops=256)
    if m["readers"]:
        m.update(rate_ops_per_s=1024, readers=2, reader_batch=8,
                 reader_rate_queries_per_s=800, reader_pool=4096,
                 broker_buckets=[8, 16], reach_check_sample=512)
    return m


def run(cell: str, seed: int = 5, seconds: float = 0.6, trace=False,
        device: str = "cpu"):
    """``run_cell`` of ``cell`` at the tiny size: (result, check lines).
    Torch's CPU ops run on one thread meanwhile, so that the run's
    sessions do not crowd the other test workers off the cores."""
    spec = harness.load_spec()
    entry = harness.cell_of(spec, cell)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return harness.run_cell(cell, seed, seconds, trace=trace,
                                device=device, spec=spec,
                                config=config(entry["config"]),
                                mix=mix(entry["traffic"]),
                                note=lambda msg: None)
    finally:
        torch.set_num_threads(threads)
