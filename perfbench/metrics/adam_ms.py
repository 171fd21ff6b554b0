"""adam_ms: Device ms a step in the optimizer's range ('step/adam')."""


def read(t):
    return t.range_ms('step/adam')
