"""query_p95_ms.serve: the 95th percentile of the window's Reachable
requests' latency (host clock), from each request's arrival to its results
in the reader, over every request sent in the window.  Above capacity the
backlog grows through the window, so it follows the service's rate."""
import numpy as np


def read(run):
    lat = [r.t_ack - r.t_submit for r in run.requests if r.t_ack is not None]
    if not lat:
        return None
    return float(np.percentile(lat, 95)) * 1e3
