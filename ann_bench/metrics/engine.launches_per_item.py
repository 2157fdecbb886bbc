"""Device kernels launched in the traced rounds per item they completed
(NCCL's kernels and copies not counted; the mean over ranks)."""


def read(ctx):
    vals = [r["trace"].kernels_in_window() / r["traced"]["items"]
            for r in ctx.ranks if r.get("trace") is not None and not r["trace"].empty
            and r["traced"]["items"]]
    return sum(vals) / len(vals) if vals else None
