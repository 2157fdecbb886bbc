"""Device time inside the ``op.query`` spans of the traced rounds per
query answered in them, in ms (the mean over ranks)."""


def read(ctx):
    vals = []
    for r in ctx.ranks:
        t = r.get("trace")
        n = r["traced"]["by_kind"]["query"] if r.get("traced") else 0
        s = None if t is None or t.empty or not n else t.in_spans_s("op.query")
        if s is not None:
            vals.append(s / n * 1e3)
    return sum(vals) / len(vals) if vals else None
