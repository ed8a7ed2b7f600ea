"""train.feed_ms: host time of a training step's feed (span
``evdr.train.feed``: the batch's indices to the device and the step's
generators) per step. Several ms where the indices' copy waits for the
previous step's kernels."""

from evdr_bench.spans import per


def read(obs):
    return per(obs, "evdr.train.feed", "host_ms", "evdr.train.step")
