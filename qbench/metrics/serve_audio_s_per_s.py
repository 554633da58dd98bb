"""Serving throughput: the audio seconds of every transcription request the
window finished, over the window's host-clock seconds."""


def read(ctx):
    w = ctx.window
    if not w["items"]:
        return None
    return sum(i["audio_s"] for i in w["items"]) / w["seconds"]
