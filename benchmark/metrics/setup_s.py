"""setup_s: seconds from process start to the window's start: the card, the
program's objects, seeded weights and inputs, the kernels built or loaded and
every shape warmed (host clock)."""


def read(ctx):
    return ctx.setup_s
