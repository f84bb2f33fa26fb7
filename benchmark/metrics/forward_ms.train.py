"""forward_ms.train: stream milliseconds a step in the model's forward (the
towers, heads and loss: models/avclip.py, models/sync_model.py), CUDA events
at the trained module's forward pre- and post-hooks over the traced units."""


def read(ctx):
    return ctx.per_unit(ctx.span_ms("forward"))
