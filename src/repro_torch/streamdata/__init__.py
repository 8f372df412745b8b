"""repro_torch.streamdata: the non-IID streaming data plane (DESIGN.md §13),
carried over from ``repro/streamdata`` (numpy only, no device work).

Partitioners + divergence metrics (``partition``), per-device streaming
sources with drift and diurnal rate curves (``generators``), and the
sharded prefetching loader with bounded buffers (``loader``).
"""
from repro_torch.streamdata.partition import (  # noqa: F401
    PARTITIONERS, Partition, dirichlet_partition, iid_partition,
    label_coverage, label_divergence, label_entropy, make_partition,
    max_divergence, quantity_skew_partition, shard_partition,
)
from repro_torch.streamdata.generators import (  # noqa: F401
    DiurnalCurve, DriftSpec, StreamingDataSource, compose_curves,
    make_stream_source, quantity_rate_curve,
)
from repro_torch.streamdata.loader import (  # noqa: F401
    ShardedStreamLoader, contiguous_placement, make_label_shards,
    make_sharded_loader, round_robin_placement,
)
