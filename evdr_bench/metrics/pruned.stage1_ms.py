"""pruned.stage1_ms: stage 1 of pruned search (``ops/pruned.candidate_scores``
and the candidates' selection) on a batch of the cell's queries, median
CUDA-event ms."""


def read(obs):
    return obs.get("pruned_stage1_ms")
