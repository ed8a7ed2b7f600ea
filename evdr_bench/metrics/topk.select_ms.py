"""topk.select_ms: device time of the top-k selections (span
``evdr.topk.select``, every stable sort) per engine search."""

from evdr_bench.spans import per


def read(obs):
    return per(obs, "evdr.topk.select", "device_ms", "evdr.engine.search")
