"""slot_use: Share of the flat trace's sample slots that carry a live
sample: the samples kept under the budget over the budget's slots, both
counted by the program's compaction over the profiled block, in percent."""


def counted(name: str):
    """The program's counter ``name`` over the profiled block (this
    process), or None where the program keeps no counters."""
    try:
        from shacira_tpu_torch.utils.perf import counted as program_counted
    except ImportError:
        return None
    return program_counted(name)


def read(t):
    kept, slots = counted('trace/kept_samples'), counted('trace/slots')
    return 100.0 * kept / slots if kept is not None and slots else None
