"""Tail latency of transcription: the 95th percentile over every request in
the window of the host-clock time from the call into
``Transcriber.transcribe_batch`` to its returned transcripts, in ms."""

import numpy as np


def read(ctx):
    lat = [i["latency_s"] for i in ctx.window["items"]]
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat), 95.0)) * 1e3
