"""Share of the profiled slice in which no operation (kernel, copy or set)
ran on the card, from the torch.profiler device trace."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 1.0 - tr.busy_s / tr.window_s
