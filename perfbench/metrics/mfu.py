"""mfu: The whole step's share of the card's bf16 dense peak: the FLOPs
the step's inputs need (``harness/roofline.py``) over the unprofiled step
time, in percent."""


def read(t):
    from perfbench.harness.roofline import BF16_FLOPS
    f, s = t.extra.get('flops_per_step'), t.extra.get('step_s')
    return 100.0 * f / s / BF16_FLOPS if f and s else None
