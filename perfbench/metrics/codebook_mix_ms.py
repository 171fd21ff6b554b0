"""codebook_mix_ms: Device ms a step in VQAD's codebook mix
('field/codebook_mix': the softmax over the gathered logits, its argmax,
the one-hot, the straight-through keys and the dictionary product), a
part of encode_ms."""


def read(t):
    return t.range_ms('field/codebook_mix')
