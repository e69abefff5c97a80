"""update_ops_per_s: update ops acknowledged over the window, summed over
sessions, per second of the window (host clock).  The window runs from its
opening to the last ack of the chunks the sessions started before the
close, so every op counted is timed whole."""


def read(run):
    done = [c for c in run.chunks if c.t_ack is not None]
    if not done:
        return None
    wall = max(c.t_ack for c in done) - run.t_open
    return sum(c.n_ops for c in done) / wall
