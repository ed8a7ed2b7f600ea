"""maxsim_int4_roofline: the share of its bound that one full-index K4
int4full MaxSim (``parallel/topk.sharded_maxsim`` on a batch of the cell's
queries, over the packed int4 index) reaches: the frozen cost function's
least time (``cost.maxsim_bound_ms`` over the cell's valid tokens and the
packed codes', scales' and mask's bytes, at the int8 peak: K4 multiplies
on the s8 tensor cores) over the median CUDA-event time."""


def read(obs):
    ms, bound = obs.get("maxsim_ms"), obs.get("maxsim_bound_ms")
    if not ms or bound is None:
        return None
    return 100.0 * bound / ms
