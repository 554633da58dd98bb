"""Device idle share of the train steps: the part of the profiled stretch's
host-clock seconds in which no operation ran on the device
(``torch.profiler``; the arithmetic of ``chip_smoke.py:_profile``), in %."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - ctx.trace.busy_s / ctx.trace.window_s)
