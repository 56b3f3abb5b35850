from .mesh import (
    shard_frames,
    maybe_distributed_init,
    is_coordinator,
    sync_processes,
)

__all__ = [
    "shard_frames",
    "maybe_distributed_init",
    "is_coordinator",
    "sync_processes",
]
