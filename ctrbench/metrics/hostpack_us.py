"""Mean microseconds of the program's numpy host pack per batch
(`batch.hostpack`: `pack_host_combined`, which packs every layout the
native pack does not take, DLRM's three inputs among them) over the window.
A program without that span reports nothing."""


def read(ctx):
    p = (ctx.window or {}).get("phases", {}).get("batch.hostpack")
    return p["seconds"] / p["count"] * 1e6 if p else None
