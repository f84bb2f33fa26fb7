"""idle_share.offline: the share of the traced window (host clock, from the
first traced unit's start to the last one's end, synchronised) in which no
kernel ran on the device (torch.profiler), in percent."""


def read(ctx):
    return ctx.idle_pct()
