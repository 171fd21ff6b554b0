"""dda_ms: Device ms a step in the voxel march's DDA ('trace/dda', opened
around the walk inside 'trace/march': kernel V1 on the card), a part of
trace_ms.  None where the program opens no such range."""


def read(t):
    return t.range_ms('trace/dda')
