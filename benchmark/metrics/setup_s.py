"""setup_s: seconds from the process's start to the first timed call
(imports, the kernel library's load or build, the ring, the channelizer,
the warm-up calls that capture the step's graph). Host clock."""


def read(ctx):
    return ctx.setup_s
