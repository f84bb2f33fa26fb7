"""audio_tower_ms.offline: stream milliseconds a batch in the audio tower
(models/ast_encoder.py with its frequency aggregator), CUDA events at its
forward's pre- and post-hooks over the traced units."""


def read(ctx):
    return ctx.per_unit(ctx.span_ms("audio_tower"))
