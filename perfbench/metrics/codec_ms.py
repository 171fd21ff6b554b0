"""codec_ms: Device ms a step of the latent codec: the quantize-and-decode
range and the rate loss ('step/decode', 'step/rate_loss')."""


def read(t):
    return t.range_ms('step/decode', 'step/rate_loss')
