"""device_idle_share.ingest: the traced window's share in which no
operation ran on the card."""


def read(run):
    t = run.trace
    if t is None or t["busy_s"] <= 0:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
