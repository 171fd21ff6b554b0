"""kept_share: Share of the live march samples that the flat trace's
compaction keeps under its budget, both counted by the program over the
profiled block, in percent."""


def counted(name: str):
    """The program's counter ``name`` over the profiled block (this
    process), or None where the program keeps no counters."""
    try:
        from shacira_tpu_torch.utils.perf import counted as program_counted
    except ImportError:
        return None
    return program_counted(name)


def read(t):
    kept, live = counted('trace/kept_samples'), counted('trace/live_samples')
    return 100.0 * kept / live if kept is not None and live else None
