"""b1_roofline: Kernel B1's share of its roofline: the least time of the
step's scatter-adds (the live rows' indices and values read once, the
table written once, at the HBM peak; ``harness/roofline.py``) over B1's
device time by name, in percent."""


def read(t):
    dev = t.kernel_ms('scatter_add_rows_kernel')
    bound = t.extra.get('b1_bound_ms')
    return 100.0 * bound / dev if dev and bound else None
