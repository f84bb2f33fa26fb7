"""video_tower_ms.offline: stream milliseconds a batch in the video tower
(models/motionformer.py with its spatial aggregator), CUDA events at its
forward's pre- and post-hooks over the traced units."""


def read(ctx):
    return ctx.per_unit(ctx.span_ms("video_tower"))
