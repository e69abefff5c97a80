"""Offer a serving cell's readers a series of rates, to find the highest
the system sustains (the cell's own rate is set at about four fifths of
it).  Runs in one process, one run a rate, each with the cell's own
configuration and mix but for ``reader_rate_queries_per_s``:

    python3 bench/sweep.py --workload smscc-1m.reach-serve --seconds 20 \
        --seed 11 --rates 4000,8000,12000

Prints one JSON line a rate: the offered and answered rates, ``correct``,
the request latency percentiles and the most late update chunk.  The
benchmark's own runs never run this.
"""
import argparse
import json
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PCT = re.compile(r"requests of ms p50/p90/p95/p99/max ([\d. ]+)")
LATE = re.compile(r"most late ([\d.e-]+) s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True,
                    help="comma-separated Reachable ops/s")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from bench import harness
    harness.use_checkout_caches()
    import torch

    if not torch.cuda.is_available():
        print("bench: no CUDA card", file=sys.stderr)
        return 3
    spec = harness.load_spec()
    mix = harness.mix_of(harness.cell_of(spec, args.workload)["traffic"])
    for rate in (float(r) for r in args.rates.split(",")):
        notes = []
        t0 = time.perf_counter()
        result, _ = harness.run_cell(
            args.workload, args.seed, args.seconds, spec=spec,
            mix=dict(mix, reader_rate_queries_per_s=rate),
            note=notes.append)
        text = "\n".join(notes)
        pct = PCT.search(text)
        late = LATE.search(text)
        print(json.dumps({
            "offered": rate, "correct": result["correct"],
            "metrics": {k: v["value"]
                        for k, v in result["metrics"].items()},
            "ms_p50_p90_p95_p99_max": pct.group(1).split() if pct else None,
            "most_late_chunk_s": float(late.group(1)) if late else None,
            "s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
