"""maxsim.index_bytes_per_query: the bytes of index operands (codes,
scales, mask) the MaxSim kernels' launches covered in the window (the
program's counter ``ops/cuda_maxsim.INDEX_BYTES_READ``: a launch takes at
most ``row_cap`` query tokens, so a batch reads the index once a slice)
over the queries answered there."""


def read(obs):
    read_, n = obs.get("index_bytes_read"), obs.get("queries")
    if read_ is None or not n:
        return None
    return read_ / n
