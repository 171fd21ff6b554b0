"""head_ms: Device ms a step in the field's MLP head range
('field/head')."""


def read(t):
    return t.range_ms('field/head')
