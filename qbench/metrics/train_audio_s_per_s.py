"""Training throughput: the real (unpadded) audio seconds of every train step
the window ran, over the window's host-clock seconds (the window ends when
the device has finished its last step)."""


def read(ctx):
    w = ctx.window
    if not w["items"]:
        return None
    return sum(i["audio_s"] for i in w["items"]) / w["seconds"]
