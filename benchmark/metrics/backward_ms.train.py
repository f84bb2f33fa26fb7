"""backward_ms.train: stream milliseconds a step from the forward's end to
the optimizer update's start: autograd through ops/autograd.py and the
kernels' Functions (CUDA events) over the traced units."""


def read(ctx):
    return ctx.per_unit(ctx.span_ms("forward->optimizer"))
