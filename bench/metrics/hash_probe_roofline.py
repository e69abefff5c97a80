"""hash_probe_roofline: the read-once bound of the edge table's insert and
remove launches (hash_probe's ``insert_rounds`` and ``remove_first``)
over their device time in the traced window, counted from the window's
AddEdge and RemoveEdge ops (``bench.roofline.insert_bytes`` and
``remove_bytes``)."""
from bench import roofline

ADD_EDGE, REM_EDGE = 0, 1


def read(run):
    if run.trace is None:
        return None
    sec = sum(s for name, (_, s) in run.trace["ops"].items()
              if "insert_rounds" in name or "remove_first" in name)
    adds = rems = 0
    for c in run.chunks:
        if c.t_ack is not None:
            kind = c.arrays[0]
            adds += int((kind == ADD_EDGE).sum())
            rems += int((kind == REM_EDGE).sum())
    return roofline.share_pct(
        roofline.insert_bytes(adds) + roofline.remove_bytes(rems), sec)
