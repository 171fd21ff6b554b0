"""chip_smoke.py's stage attribution of profiler events.

No JAX import and no card: the events are stand-ins with the attributes
of ``torch.autograd.profiler_util.FunctionEvent`` that the attribution
reads.  PyTorch attaches a kernel to every CPU event that carries its
launch's correlation id; CUPTI's 'Command Buffer Full' event nests inside
the launching op with that id when the host waits for room in the launch
queue, so ``device_time_total`` counts the kernel twice.  The attribution
counts it once, and leaves a nested range to count its own kernels."""
from collections import namedtuple

import chip_smoke

Kernel = namedtuple('Kernel', ['name', 'device', 'duration'])


class Event:
    def __init__(self, name, id_, kernels=(), children=()):
        self.name, self.id = name, id_
        self.kernels = [Kernel(n, 0, d) for n, d in kernels]
        self.cpu_children = list(children)

    @property
    def device_time_total(self):
        return (sum(k.duration for k in self.kernels)
                + sum(c.device_time_total for c in self.cpu_children))


def test_a_kernel_recarried_by_a_nested_event_counts_once():
    full = Event('Command Buffer Full', 7, [('gather', 40.0)])
    launch = Event('cudaLaunchKernel', 70, children=[full])
    op = Event('aten::index', 7, [('gather', 40.0)], [launch])
    other = Event('aten::mul', 8, [('mul', 5.0)])
    rng = Event('field/encode', 1, children=[op, other])
    assert rng.device_time_total == 85.0
    assert chip_smoke._range_device_us(rng) == (45.0, 40.0)


def test_nested_ranges_count_their_own_kernels():
    inner = Event('field/head', 2, children=[Event('aten::mm', 9,
                                                   [('gemm', 3.0)])])
    outer = Event('trace/march', 1,
                  children=[Event('aten::add', 4, [('add', 1.0)]), inner])
    assert chip_smoke._range_device_us(outer) == (1.0, 0.0)
    assert chip_smoke._range_device_us(inner) == (3.0, 0.0)
