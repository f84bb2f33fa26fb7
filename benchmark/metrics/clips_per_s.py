"""clips_per_s: every clip whose probabilities reached the host in the window,
over the window's seconds (host clock)."""


def read(ctx):
    return ctx.items / ctx.window_s if ctx.window_s > 0 and ctx.items else None
