"""crossing_use: Share of the voxel march's crossing slots (``R x
max_intersections`` a step) that hold a valid crossing of an occupied
cell, the crossings counted by the program's DDA over the profiled block
('trace/crossings'), in percent."""


def counted(name: str):
    """The program's counter ``name`` over the profiled block (this
    process), or None where the program keeps no counters."""
    try:
        from shacira_tpu_torch.utils.perf import counted as program_counted
    except ImportError:
        return None
    return program_counted(name)


def read(t):
    n, slots = counted('trace/crossings'), t.extra.get('crossing_slots')
    return 100.0 * n / (slots * t.steps) if n and slots else None
