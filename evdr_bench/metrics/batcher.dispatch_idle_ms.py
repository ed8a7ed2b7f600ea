"""batcher.dispatch_idle_ms: the device-idle time inside the serving
batcher's dispatches (span ``evdr.batcher.dispatch``: assembling the group,
the engine's search, scattering the answers), per dispatch."""

from evdr_bench.spans import per


def read(obs):
    return per(obs, "evdr.batcher.dispatch", "idle_ms")
