"""mesh.gather_bytes_per_query: the bytes a mesh search moved between
devices in the window (the program's counter ``parallel/mesh.
TRANSFER_BYTES``: queries out to the shards, candidates back) over the
queries answered there."""


def read(obs):
    moved, n = obs.get("mesh_gather_bytes"), obs.get("queries")
    if moved is None or not n:
        return None
    return moved / n
