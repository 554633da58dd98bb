"""The arithmetic of the readers of the program's own spans
(``qasr_torch.utils.profiling.SPANS``; ``qbench/metrics/*_ms_per_audio_s.*``)."""


def span_ms_per_audio_s(ctx, ops) -> float | None:
    """Device milliseconds under the spans ``ops`` (forward and backward) per
    real audio second of the traced run's profiled steps; None without a
    trace or where the spans did not run."""
    if ctx.trace is None:
        return None
    device = ctx.trace.device_s(ops=ops)
    audio = sum(i["audio_s"] for i in ctx.profiled["items"])
    if not device or not audio:
        return None
    return 1e3 * device / audio
