"""device_ops_per_step: Device operations (kernels, copies, fills) a step
in the profiled block."""


def read(t):
    return t.device_ops / t.steps if t.device_ops else None
