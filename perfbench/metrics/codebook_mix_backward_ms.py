"""codebook_mix_backward_ms: Device ms a step in the backward of VQAD's
codebook mix ('backward/codebook_mix', opened on autograd's thread around
kernel M1(b): the logits' and the dictionaries' gradients of the
straight-through mix and its blend), a part of backward_ms.  None where
the program opens no such range."""


def read(t):
    return t.range_ms('backward/codebook_mix')
