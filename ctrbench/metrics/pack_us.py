"""Mean microseconds of the program's native host pack per batch
(`batch.fusedpack`, the fused path's pack into the pinned ring) over the
window. Paths that pack without that span report nothing."""


def read(ctx):
    p = ctx.window["phases"].get("batch.fusedpack")
    return p["seconds"] / p["count"] * 1e6 if p else None
