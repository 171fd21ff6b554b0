"""backward_ms: Device ms a step outside the program's ranges of the
forward, the optimizer and the trainer's own steps: the backward, which
autograd runs on its own thread (kernel B1's scatter among it).  The
ranges taken out are listed here, so that a range the program adds later
(around the backward, a prune) leaves this number as it is."""

FORWARD_AND_STEP = (
    'step/draws', 'step/recalib', 'step/decode', 'trace/march',
    'trace/group', 'trace/compact', 'field/encode', 'field/paged_encode',
    'field/finish', 'field/head', 'trace/integrate', 'step/rate_loss',
    'step/adam', 'step/best')


def read(t):
    rest = t.busy_ms - sum(t.ranges_ms.get(r, 0.0) for r in FORWARD_AND_STEP)
    return rest if rest > 0 else None
