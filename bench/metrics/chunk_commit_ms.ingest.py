"""chunk_commit_ms.ingest: the median time of an update chunk's
submit_many, from the call to its acks on the host (the benchmark's own
span around the client entry)."""
import statistics


def read(run):
    t = [c.t_ack - c.t_submit for c in run.chunks if c.t_ack is not None]
    return statistics.median(t) * 1e3 if t else None
