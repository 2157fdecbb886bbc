"""Collective seconds (sync to sync, the replica and pod-peer groups) per
query op, in ms, the mean over ranks; None without collectives."""


def read(ctx):
    vals = [r["collective_query_s"] / r["query_ops"] * 1e3 for r in ctx.ranks
            if r.get("collective_query_s") is not None and r["query_ops"]]
    return sum(vals) / len(vals) if vals else None
