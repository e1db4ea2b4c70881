from repro_torch.kernels.segsum.ops import (  # noqa: F401
    EdgeGraph,
    SegmentCSR,
    edge_graph,
    segment_sum,
    segsum,
)
