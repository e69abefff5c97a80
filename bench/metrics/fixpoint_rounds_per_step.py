"""fixpoint_rounds_per_step: rounds the update step's fixpoint launches
ran on the card (reach, pair, label, prio and trim forms, the static
SCC's sweeps included; the program's device counter read before and after
the window), over the window's update steps."""

FORMS = ("reach", "pair", "label", "prio", "trim")


def read(run):
    rounds = run.counters.get("fixpoint_rounds")
    steps = sum(run.sizes["steps_per_chunk"] for c in run.chunks
                if c.t_ack is not None)
    if not rounds or not steps:
        return None
    return sum(rounds[f] for f in FORMS) / steps
