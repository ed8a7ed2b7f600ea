"""engine.idle_ms: the device-idle time inside the engine's searches (span
``evdr.engine.search``: the queries to the device, scoring, top-k, the
results to the host), per call."""

from evdr_bench.spans import per


def read(obs):
    return per(obs, "evdr.engine.search", "idle_ms")
