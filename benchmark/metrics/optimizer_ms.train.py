"""optimizer_ms.train: stream milliseconds a step in the update
(train/step.py::_apply_update: the global-norm clip and the optimizer,
train/state.py), CUDA events around each call over the traced units."""


def read(ctx):
    return ctx.per_unit(ctx.span_ms("optimizer"))
