"""Read the check's numbers of sound and broken runs of one cell, many
seeds in one process (the kernels load once).

    python3 bench/control.py --workload smscc-1m.ingest --seconds 5 \
        --sound 11,12,13 --broken repair_skipped --seeds 21,22,23

Prints one JSON line a run: the seed, what was broken (``null`` for a
sound run), ``correct`` and every compared number.  The benchmark's own
runs never run this; it sets and re-checks the limits.
"""
import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--sound", default="", help="seeds of sound runs")
    ap.add_argument("--broken", default="",
                    help="comma-separated controls or faults")
    ap.add_argument("--seeds", default="", help="seeds of each broken run")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from bench import controls, harness
    harness.use_checkout_caches()
    import torch

    from repro_torch.core import step_graph

    if not torch.cuda.is_available():
        print("bench: no CUDA card", file=sys.stderr)
        return 3
    seeds = [int(s) for s in args.seeds.split(",") if s]
    plan = [(int(s), None) for s in args.sound.split(",") if s]
    plan += [(s, b) for b in args.broken.split(",") if b for s in seeds]
    for seed, name in plan:
        t0 = time.perf_counter()
        ctx = controls.broken(name) if name else contextlib.nullcontext()
        try:
            with ctx:
                result, _ = harness.run_cell(args.workload, seed,
                                             args.seconds)
            out = {"correct": result["correct"],
                   "checks": {k: v["value"]
                              for k, v in result["checks"].items()},
                   "metrics": {k: v["value"]
                               for k, v in result["metrics"].items()}}
        except Exception as e:  # a broken run that crashes has failed
            out = {"correct": False, "error": repr(e)[:300]}
        out.update(seed=seed, broken=name, s=time.perf_counter() - t0)
        print(json.dumps(out), flush=True)
        step_graph.clear()  # no graph of a broken step outlives its run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
