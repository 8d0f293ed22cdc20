"""Share of the rows the device computed that were padding: 1 - candidates /
padded_candidates of the program's BatcherStats over the window."""


def read(ctx):
    s = ctx.window["stats"]
    padded = s.get("padded_candidates", 0)
    return 1.0 - s.get("candidates", 0) / padded if padded else None
