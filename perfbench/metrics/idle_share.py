"""idle_share: Share of the profiled block's wall time in which the device
ran nothing, in percent."""


def read(t):
    return 100.0 * (1.0 - t.busy_s / t.wall_s) if t.busy_s > 0 else None
