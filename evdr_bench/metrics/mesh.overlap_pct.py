"""mesh.overlap_pct: how far the doc shards of a mesh search overlap: 100 x
the slowest shard's scores and local top-k (``parallel/topk.shard_topk``,
each shard alone on its card, median CUDA-event ms) over one whole
``sharded_topk`` call with every card synchronized (median host ms), on
one batch of the cell's queries. ~100 where the shards run at once, ~100
/ shards where they run one after another."""


def read(obs):
    shard, call = obs.get("mesh_shard_ms"), obs.get("mesh_call_ms")
    if not shard or not call:
        return None
    return 100.0 * shard / call
