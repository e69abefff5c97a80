"""queries_per_s: Reachable ops answered, over the time from the window's
opening to the last answer of a request sent in it (host clock).  Above
capacity, where the readers always have a request due, it reads the rate
the service sustains."""


def read(run):
    done = [r for r in run.requests if r.t_ack is not None]
    if not done:
        return None
    wall = max(r.t_ack for r in done) - run.t_open
    return sum(r.u.shape[0] for r in done) / wall
