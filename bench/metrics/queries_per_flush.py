"""queries_per_flush: queries the broker answered over the window, per
flush (the broker's own counters): how far concurrent readers coalesce."""


def read(run):
    b = run.counters.get("broker")
    if not b or not b["flushes"]:
        return None
    return b["served"] / b["flushes"]
