"""mesh.merge_ms: the merge of a mesh search (``parallel/topk.
merge_shard_topk``: every shard's candidates to the first card and one
stable sort) on one call's shard outputs, median CUDA-event ms on the
first card."""


def read(obs):
    return obs.get("mesh_merge_ms")
