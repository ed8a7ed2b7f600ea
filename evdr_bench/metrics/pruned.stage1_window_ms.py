"""pruned.stage1_window_ms: device time of stage 1 of pruned search (span
``evdr.pruned.stage1``: the summaries' scores and the candidates'
selection) per call, in the window."""

from evdr_bench.spans import per


def read(obs):
    return per(obs, "evdr.pruned.stage1", "device_ms")
