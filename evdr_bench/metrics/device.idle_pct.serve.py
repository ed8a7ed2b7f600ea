"""device.idle_pct.serve: the share of a closed search loop's traced window
in which no kernel, copy or set ran on the card."""

from evdr_bench.trace import idle_pct


def read(obs):
    return idle_pct(obs, "calls")
