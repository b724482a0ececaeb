"""stream_msps: input samples of every process() call that returned
inside the window, in millions, over the window's seconds. Host clock."""


def read(ctx):
    if ctx.window_s is None:
        return None
    return ctx.samples_done / ctx.window_s / 1e6
