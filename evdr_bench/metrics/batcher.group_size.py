"""batcher.group_size: requests a dispatch of the serving batcher carried,
averaged over the window's requests (``_BatchReq.batched_with``, a program
counter)."""


def read(obs):
    sizes = obs.get("batched_with")
    if not sizes:
        return None
    return sum(sizes) / len(sizes)
