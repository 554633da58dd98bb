"""Set-up seconds: from the process's start through loading, the weights
made on the device, the first steps or requests and every shape warmed (and,
in a checkout's first run, the kernels' build), to the window's start."""


def read(ctx):
    return ctx.setup_s
