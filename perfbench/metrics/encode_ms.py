"""encode_ms: Device ms a step in the field's encode range
('field/encode'; the image's holds its MLP head too)."""


def read(t):
    return t.range_ms('field/encode')
