"""pruned.stage2_ms: stage 2 of pruned search (``ops/pruned.rerank_candidates``)
on a batch of the cell's queries and stage 1's candidates, median
CUDA-event ms."""


def read(obs):
    return obs.get("pruned_stage2_ms")
