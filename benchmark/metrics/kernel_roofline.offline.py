"""kernel_roofline.offline: the sum of the kernel wrapper calls' bounds (the
larger of bytes at 3.35 TB/s and FLOPs at 989 TFLOP/s, from the shapes of
what each computes; flops/kernels.py) over the sum of their measured stream
times, in percent, over the traced units."""


def read(ctx):
    return ctx.roofline_pct()
