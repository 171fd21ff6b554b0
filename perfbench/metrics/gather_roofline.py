"""gather_roofline: The octree grids' corner gather's share of its
roofline: the least time of the step's gather (every gathered row
written once and its index read once, at the HBM peak;
``harness/vqad.py``) over the device time of 'field/gather', in
percent."""


def read(t):
    dev = t.range_ms('field/gather')
    bound = t.extra.get('gather_bound_ms')
    return 100.0 * bound / dev if dev and bound else None
