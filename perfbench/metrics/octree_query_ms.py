"""octree_query_ms: Device ms a step in the octree grids' corner query
('field/octree_query': each sample's cell per LOD, its morton search, the
trinkets' corner rows and the trilinear weights), a part of encode_ms."""


def read(t):
    return t.range_ms('field/octree_query')
