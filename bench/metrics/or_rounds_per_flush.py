"""or_rounds_per_flush: rounds the packed Reachable sweeps (the fixpoint
launches' OR form) ran on the card over the window, per broker flush."""


def read(run):
    rounds = run.counters.get("fixpoint_rounds")
    b = run.counters.get("broker")
    if not rounds or not b or not b["flushes"]:
        return None
    return rounds["or"] / b["flushes"]
