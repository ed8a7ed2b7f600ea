"""maxsim.score_ms: device time of the MaxSim kernels (span
``evdr.topk.score``, every route of ``parallel/topk._local_scores``) per
engine search, in the window."""

from evdr_bench.spans import per


def read(obs):
    return per(obs, "evdr.topk.score", "device_ms", "evdr.engine.search")
