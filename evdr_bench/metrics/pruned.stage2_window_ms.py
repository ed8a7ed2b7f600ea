"""pruned.stage2_window_ms: device time of stage 2 of pruned search (span
``evdr.pruned.stage2``: the candidates' exact rerank and top-k) per call,
in the window."""

from evdr_bench.spans import per


def read(obs):
    return per(obs, "evdr.pruned.stage2", "device_ms")
