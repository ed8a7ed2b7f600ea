"""maxsim_roofline: the share of its bound that one full-index MaxSim
(``parallel/topk.sharded_maxsim`` on a batch of the cell's queries) reaches:
the frozen cost function's least time (``cost.maxsim_bound_ms`` over the
cell's valid tokens and index bytes) over the median CUDA-event time."""


def read(obs):
    ms, bound = obs.get("maxsim_ms"), obs.get("maxsim_bound_ms")
    if not ms or bound is None:
        return None
    return 100.0 * bound / ms
