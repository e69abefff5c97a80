"""frontier_min_roofline.serve: the read-once bound of the packed
Reachable sweeps (frontier_min's ``fixpoint_rounds`` in its OR form) over
their device time in the traced window.  Each launch reads the live graph
once; the queries' reached bits, 32 to a word, are read and written once
for every query the broker answered in the window
(``bench.roofline.packed_sweeps_bytes``)."""
import re

from bench import roofline

FORM = re.compile(r"fixpoint_rounds<4>")


def read(run):
    b = run.counters.get("broker")
    if run.trace is None or not b:
        return None
    n, sec = 0, 0.0
    for name, (count, s) in run.trace["ops"].items():
        if FORM.search(name):
            n += count
            sec += s
    size = run.sizes
    return roofline.share_pct(roofline.packed_sweeps_bytes(
        n, size["live_edges"], size["n_vertices"], b["served"]), sec)
