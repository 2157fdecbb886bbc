"""The share of the traced rounds in which no compute kernel, copy or
fill ran on the card (NCCL's kernels count as idle), in %, the mean over
ranks."""


def read(ctx):
    vals = [100.0 * (1.0 - r["trace"].busy_s() / r["trace"].window_s)
            for r in ctx.ranks if r.get("trace") is not None and not r["trace"].empty and r["trace"].window_s > 0]
    return sum(vals) / len(vals) if vals else None
