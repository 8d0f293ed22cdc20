"""Mean microseconds of the program's `predict.decode` phase per Predict over
the window (the service's wire decode; the `/monitoring` `phases` block)."""


def read(ctx):
    p = ctx.window["phases"].get("predict.decode")
    return p["seconds"] / p["count"] * 1e6 if p else None
