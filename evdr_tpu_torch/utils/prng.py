"""Seeding: numpy host RNG + a stream of torch seeds (the port of
``evdr_tpu/utils/prng.py``, whose ``PRNGSequence`` threads JAX keys).

Each ``next()`` draws a fresh 62-bit seed from a CPU ``torch.Generator``;
the caller seeds a generator on its own device with it
(:func:`generator_for`). The numbers differ from JAX's keys for the same
seed; tests that compare the two packages hand both the same noise.
"""

from __future__ import annotations

import numpy as np
import torch


def set_seed(seed: int) -> "PRNGSequence":
    np.random.seed(seed)
    torch.manual_seed(seed)
    return PRNGSequence(seed)


class PRNGSequence:
    """Stateful stream of seeds, one per ``next()``."""

    def __init__(self, seed: int):
        self._gen = torch.Generator().manual_seed(int(seed))

    def next(self) -> int:
        return int(torch.randint(0, 2 ** 62, (1,), generator=self._gen))

    __next__ = next

    def advance(self, n: int) -> None:
        """Skip ``n`` draws (as ``n`` ``next()`` calls): ``--resume``
        fast-forwards to the checkpoint step with it."""
        for _ in range(int(n)):
            self.next()


def generator_for(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with one draw of the stream."""
    return torch.Generator(device=device).manual_seed(int(seed))
