"""transport.alltoall_gbps: the bytes the ShardedTransport's re-splits
moved between slots over their seconds (``stats()``), GB/s."""


def read(rec):
    s = rec.stats.get("alltoall_s", 0.0)
    if s <= 0:
        return None
    return rec.stats["alltoall_bytes"] / s / 1e9
