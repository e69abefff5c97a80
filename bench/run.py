"""Run one benchmark cell once and print its result line.

    python3 bench/run.py --workload smscc-1m.ingest --seed 7 \
        --seconds 20 --trace 0

Sets up, warms up, measures for ``--seconds``, checks the window's outputs
against the plain reference, and prints one JSON object as the last line
of standard output (the compared numbers, each beside its limit, are the
last lines of standard error).  ``--trace 1`` traces the window with
``torch.profiler`` and reports the cell's per-layer metrics in place of
its end-to-end ones.  Exits non-zero, printing no result, where there is
no CUDA card (or fewer than the cell asks for), or where the JAX package
or JAX was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from bench import harness
    harness.use_checkout_caches()
    import torch
    print(f"bench: set-up: torch imported at "
          f"{time.perf_counter() - T_START} s", file=sys.stderr)

    spec = harness.load_spec()
    entry = harness.cell_of(spec, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"bench: no CUDA card for {args.workload} (it asks for "
              f"{entry['chips']}); nothing measured", file=sys.stderr)
        return 3
    result, lines = harness.run_cell(args.workload, args.seed, args.seconds,
                                     trace=bool(args.trace), spec=spec,
                                     t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"bench: the run loaded {bad}; no result", file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
