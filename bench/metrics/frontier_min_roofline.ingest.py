"""frontier_min_roofline.ingest: the read-once bound of the update step's
fixpoint and static-SCC launches (frontier_min's ``fixpoint_rounds`` in
every form but OR, and ``scc_rounds``), over their device time in the
traced window.  Each launch is counted as one sweep of the live graph
(``bench.roofline.sweep_bytes``)."""
import re

from bench import roofline

FORM = re.compile(r"fixpoint_rounds<(\d+)>")
OR_FORM = 4  # the packed Reachable form of the kernel's Form enum


def read(run):
    if run.trace is None:
        return None
    n, sec = 0, 0.0
    for name, (count, s) in run.trace["ops"].items():
        m = FORM.search(name)
        if (m and int(m.group(1)) != OR_FORM) or "scc_rounds" in name:
            n += count
            sec += s
    size = run.sizes
    return roofline.share_pct(
        n * roofline.sweep_bytes(size["live_edges"], size["n_vertices"]),
        sec)
