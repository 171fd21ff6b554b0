"""trace_ms: Device ms a step in the tracer's ranges: the march over the
occupancy grid, the compaction to the sample budget and the volume
integration."""


def read(t):
    return t.range_ms('trace/march', 'trace/compact', 'trace/integrate')
