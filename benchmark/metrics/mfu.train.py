"""mfu.train: the configuration's analytic model FLOPs of the work the traced
units completed (flops/model.py) over the traced window times the card's
dense bf16 peak (989 TFLOP/s), in percent."""


def read(ctx):
    return ctx.mfu_pct()
