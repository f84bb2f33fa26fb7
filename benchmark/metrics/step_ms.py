"""step_ms: the window's milliseconds over the steps completed in it; a step
is complete once its returned metrics are on the host (host clock)."""


def read(ctx):
    return ctx.window_s * 1e3 / ctx.units if ctx.units else None
