"""The 90th percentile of the window's query-op latencies on rank 0 (issue
to answers on the host), in ms, over the ops after the traced rounds (all
of them in an untraced run); nothing below 10 ops."""
import numpy as np


def read(ctx):
    r = ctx.ranks[0]
    lat = r["latency_s"][r["untraced_from"]:]
    return float(np.percentile(lat, 90)) * 1e3 if len(lat) >= 10 else None
