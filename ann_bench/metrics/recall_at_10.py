"""Mean recall@10 of the sampled query lanes against the exact top-10
among the rows alive when each was asked (the reference, after the
window)."""


def read(ctx):
    return ctx.run["checks"]["recall_at_10"]
