"""Multi-device scaling: time-sharded PFB analysis, the reshard to
carrier-sharded rows and the carrier-parallel back end (counterpart of
gmr1_tpu/parallel/).

The JAX package runs these as one SPMD program over a device mesh and
ICI collectives.  Here a `Mesh` is an ordered list of torch devices in
one process (a device may repeat), and `analyze_reshard` also runs over
a torch.distributed process group, one shard per rank.
"""

from .ingest import (Mesh, ShardedRows, analyze_reshard, ici_bytes_per_step,
                     overlapped_shards)
from .transponder import ShardedTransponder, StreamingTransponder

__all__ = ["Mesh", "ShardedRows", "ShardedTransponder",
           "StreamingTransponder", "analyze_reshard", "ici_bytes_per_step",
           "overlapped_shards"]
