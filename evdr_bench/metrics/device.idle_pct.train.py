"""device.idle_pct.train: the share of the training loop's traced window in
which no kernel, copy or set ran on the card."""

from evdr_bench.trace import idle_pct


def read(obs):
    return idle_pct(obs, "steps")
