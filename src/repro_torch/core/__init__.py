"""ScaDLES core of the port: the paper's primary contribution as composable
modules (streams, buffers, clock, weighted aggregation, adaptive top-k,
injection, and the trainer that runs them)."""
from repro_torch.core.buffer import (  # noqa: F401
    PERSISTENCE, TRUNCATION, CountingBuffer, SampleBuffer, queue_size_eqn2,
    queue_size_eqn3, simulate_queue_growth,
)
from repro_torch.core.compression import (  # noqa: F401
    AdaptiveCompressor, EWMA, energy_gap, flatten_grads,
    flatten_stacked_grads, global_topk, sparsify_mask,
)
from repro_torch.core.injection import (  # noqa: F401
    inject_batches, injection_overhead_bytes, injection_plan,
)
from repro_torch.core.scadles import ScaDLESConfig, ScaDLESTrainer  # noqa: F401
from repro_torch.core.simclock import EdgeClock, EdgeClockConfig  # noqa: F401
from repro_torch.core.streams import (  # noqa: F401
    TABLE_I, StreamDist, StreamSimulator, streaming_latency,
)
from repro_torch.core.weighted_agg import (  # noqa: F401
    clip_batch, linear_scaled_lr, psum_weighted, rate_weights,
    weighted_aggregate,
)
