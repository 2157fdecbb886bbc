"""Queries answered, rows inserted and ids deleted (acknowledged), over
the window's wall time."""


def read(ctx):
    return ctx.run["items"] / ctx.run["window_s"]
