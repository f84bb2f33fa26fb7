"""kernel_ms.train: stream milliseconds a step inside the port's kernel
wrappers (the functions that enqueue each kernel of ops/kernels/*.py), CUDA
events around every call over the traced units."""


def read(ctx):
    return ctx.per_unit(ctx.wrapper_ms())
