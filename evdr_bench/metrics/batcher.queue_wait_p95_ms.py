"""batcher.queue_wait_p95_ms: the 95th percentile (nearest rank) of the
window's requests' queue waits in the serving batcher, from submit to the
start of their dispatch (``_BatchReq.t_start - t_submit``, program
counters)."""

import math


def read(obs):
    waits = obs.get("queue_wait_ms")
    if not waits:
        return None
    s = sorted(waits)
    return float(s[max(0, math.ceil(0.95 * len(s)) - 1)])
