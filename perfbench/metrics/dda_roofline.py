"""dda_roofline: Kernel V1's share of its roofline: the least time of the
step's DDA (the rays and the occupancy grid read once, every crossing
slot's entry, exit and valid flag written once, at the HBM peak;
``harness/voxel.py``) over V1's device time by name, in percent."""


def read(t):
    dev = t.kernel_ms('voxel_dda')
    bound = t.extra.get('dda_bound_ms')
    return 100.0 * bound / dev if dev and bound else None
