"""Job and tile parallelism (port of ``smcdet_tpu/parallel``).

``distributed`` splits an experiment's batches over processes started
with ``torch.distributed`` (gloo; each process may share one card), and
``sharding`` splits the tile axis of the samplers over a list of devices.
"""

from smcdet_tpu_torch.parallel.distributed import (  # noqa: F401
    host_shard,
    initialize_distributed,
    is_distributed,
)
from smcdet_tpu_torch.parallel.sharding import (  # noqa: F401
    level_split,
    shard_generator,
    tile_shards,
    to_device,
)
