"""encode_backward_ms: Device ms a step in the hash encode's backward
('backward/encode', opened on autograd's thread: the update products and
kernel B1's scatter into the table), a part of backward_ms."""


def read(t):
    return t.range_ms('backward/encode')
