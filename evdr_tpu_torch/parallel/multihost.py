"""One process per GPU: a doc mesh across ``torch.distributed`` processes.

Counterpart of ``evdr_tpu/parallel/multihost.py``. The in-process mesh
(``parallel/mesh.py``) covers the GPUs one process drives; serving a corpus
larger than one host's cards runs one process per GPU (or per host), and
needs:

1. :func:`init_multihost`: join the process group, with an explicit
   backend: ``nccl`` for one GPU per process, ``gloo`` on the CPU and for
   several processes on one card (NCCL refuses two ranks on one GPU).
   Nothing switches backends on a failure. A second, gloo, group carries
   the coordinator's host broadcasts.
2. :func:`global_doc_mesh` / :func:`global_doc_mesh_2d`: the mesh whose
   global shard ``rank * n_local + i`` is this process's ``i``-th shard.
3. :func:`build_multihost_index` (and :func:`shard_docs_global`): every
   process passes the same full-corpus view (a memory-mapped packed file)
   and reads only the rows its shards own, into the layout of
   ``sharded_index.build_sharded_index``.
4. :class:`MultihostSearchCoordinator`: every search and mutation is a
   collective that all processes must enter with the same inputs, so
   process 0 broadcasts a fixed six-int32 header and the inputs, and the
   others mirror it in :meth:`~MultihostSearchCoordinator.follow`.

Candidates, score blocks and snapshot rows travel on the data group
(``mesh.gather_blocks``: gloo stages CUDA tensors through host memory, NCCL
gathers them on the card). Tested on the CPU by
``tests/test_torch_multihost.py`` (two gloo processes of two shards each).
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch

from evdr_tpu_torch.parallel.mesh import (DOC_AXIS, DP_AXIS, DeviceMesh,
                                          gather_blocks)
from evdr_tpu_torch.parallel.sharded_index import (ShardedIndex, _pad_docs,
                                                   as_tensor,
                                                   build_sharded_index,
                                                   shard_range)

BACKENDS = ("nccl", "gloo")
_CTRL = {}


def init_multihost(coordinator: str, num_processes: int, process_id: int,
                   backend: str) -> None:
    """Join the process group at ``tcp://coordinator`` (process 0's
    "host:port") as rank ``process_id`` of ``num_processes``, on
    ``backend`` ('nccl' or 'gloo'), and make the gloo group of the host
    broadcasts. 'nccl' needs a GPU, and sets this process's current
    device to ``cuda:{process_id % device_count}``."""
    import torch.distributed as dist

    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if backend == "nccl":
        from evdr_tpu_torch.engine import resolve_device

        resolve_device("cuda")
        torch.cuda.set_device(int(process_id) % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes),
                            rank=int(process_id))
    _CTRL["group"] = dist.new_group(backend="gloo")


def _local_device(device, rank: int) -> torch.device:
    from evdr_tpu_torch.engine import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def _global_mesh(shape, axes, n_local: int, device) -> DeviceMesh:
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    backend = dist.get_backend()
    dev = _local_device(device, rank)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("an NCCL group needs its shards on a GPU")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return DeviceMesh((dev,) * int(n_local), tuple(shape), axes,
                      group=dist.group.WORLD, ctrl_group=_CTRL["group"],
                      rank=rank, world=world, backend=backend)


def global_doc_mesh(n_local: int = 1, device=None) -> DeviceMesh:
    """1D doc mesh over every process's ``n_local`` shards (each process
    builds the same). The shards lie on ``device``, by default
    ``cuda:{rank % device_count}``."""
    import torch.distributed as dist

    return _global_mesh((dist.get_world_size() * int(n_local),),
                        (DOC_AXIS,), n_local, device)


def global_doc_mesh_2d(dp: int, docs: int, n_local: int = 1,
                       device=None) -> DeviceMesh:
    """Global dp x docs mesh (``mesh.make_mesh_2d``'s layout)."""
    import torch.distributed as dist

    total = dist.get_world_size() * int(n_local)
    if int(dp) * int(docs) != total:
        raise ValueError(f"dp*docs = {int(dp) * int(docs)} must equal the "
                         f"global shard count {total}")
    return _global_mesh((int(dp), int(docs)), (DP_AXIS, DOC_AXIS), n_local,
                        device)


def replicate_global(x, mesh: DeviceMesh) -> torch.Tensor:
    """Identical host data on every process (the query batch) -> a tensor
    on this process's first shard device (the shards copy it from there)."""
    return as_tensor(np.asarray(x), mesh.devices[0])


def to_replicated(parts, mesh: DeviceMesh) -> torch.Tensor:
    """A doc-sharded array (``parts``: this process's shards) whole on this
    process's first device, rows in global order (a collective across
    processes)."""
    blocks = gather_blocks(parts, mesh, mesh.devices[0])
    return torch.cat(blocks[:mesh.n_doc_shards])


def gather_to_host(parts, mesh: DeviceMesh,
                   chunk_bytes: int = 1 << 28) -> np.ndarray:
    """Host numpy copy of a doc-sharded array (``parts``: this process's
    shards, each of the same rows) in global row order, from the first dp
    group's shards. Across processes a collective that moves a bounded
    chunk of rows of every shard at a time (about ``chunk_bytes`` a
    process), so no device ever holds the whole array."""
    d = mesh.n_doc_shards
    if not mesh.multiprocess:
        return torch.cat([t.cpu() for t in parts[:d]]).numpy()
    rows = int(parts[0].shape[0])
    row_bytes = max(1, int(np.prod(parts[0].shape[1:], dtype=np.int64))
                    * parts[0].element_size())
    step = max(1, min(rows, chunk_bytes // (row_bytes * mesh.n_local)))
    pieces = [[] for _ in range(d)]
    for lo in range(0, rows, step):
        blocks = gather_blocks([t[lo:lo + step] for t in parts], mesh,
                               parts[0].device)
        for c in range(d):
            pieces[c].append(blocks[c].cpu())
    return torch.cat([torch.cat(p) for p in pieces]).numpy()


def shard_docs_global(x, mesh: DeviceMesh, n_pad: Optional[int] = None):
    """This process's shards of a doc-axis array: every process passes the
    same full view ``x`` (a memory map is fine) and reads only the rows its
    shards own, zero-padded to ``n_pad`` global rows (default: the rows
    rounded up to the doc-shard count). Returns one tensor per local
    shard."""
    n = int(x.shape[0])
    d = mesh.n_doc_shards
    if n_pad is None:
        n_pad = -(-n // d) * d
    rows = int(n_pad) // d
    out = []
    for _, col, dev in mesh.local_shards():
        lo, hi = shard_range(rows, col, n)
        out.append(_pad_docs(as_tensor(x[lo:hi], dev), rows))
    return out


def build_multihost_index(P_full, pmask, mesh: DeviceMesh, docids=None,
                          dtype: Optional[str] = None, pad_docs_to: int = 64,
                          scales=None) -> ShardedIndex:
    """The global doc-sharded index, each process touching only its rows.

    Every process calls it with the same full-corpus view (memory-mapped:
    ``load_packed_payload(..., mmap_docs=True)``) and arguments; each
    reads the row ranges of its shards (a read-only slice streams to the
    device a bounded chunk at a time), quantizes them shard by shard
    (per-token, so exactly as a whole-array pass) and keeps them on its
    devices. The layout is ``build_sharded_index``'s; packed int4 codes
    keep ceil(Lp/2) token-pair rows beside ``pmask``'s Lp."""
    return build_sharded_index(P_full, pmask, mesh, dtype=dtype,
                               pad_docs_to=pad_docs_to, scales=scales,
                               docids=docids)


class MultihostSearchCoordinator:
    """Search coordination for one process per GPU.

    Every search and mutation of a multi-process engine is a collective,
    so process 0 is the frontend: each call first broadcasts a fixed
    six-int32 header (opcode and the shapes), then its inputs, on the
    mesh's gloo control group; the other processes sit in :meth:`follow`,
    receive them and make the same call. It offers the engine surface
    ``tools/serve_http.make_server`` uses, so it drops in as the server's
    engine. The frontend must serialize its calls (the server's single
    dispatcher thread and engine lock do): two interleaved broadcast
    streams would desynchronize the followers.
    """

    OP_STOP, OP_SEARCH = 0, 1
    OP_ADD, OP_DELETE, OP_COMPACT, OP_SNAPSHOT = 2, 3, 4, 5

    def __init__(self, engine):
        mesh = engine.mesh
        if mesh is None or not mesh.multiprocess:
            raise ValueError("the coordinator serves an engine on a mesh "
                             "across processes (global_doc_mesh)")
        self.engine = engine
        self.mesh = mesh

    # --- engine surface (frontend) --------------------------------------
    @property
    def n_docs(self):
        return self.engine.n_docs

    @property
    def dim(self):
        return self.engine.dim

    @property
    def dtype(self):
        return self.engine.dtype

    @property
    def impl(self):
        return self.engine.impl

    @property
    def device(self):
        return self.engine.device

    @property
    def summary(self):
        return self.engine.summary

    @property
    def index(self):
        return self.engine.index

    def ids_for(self, idx):
        return self.engine.ids_for(idx)

    def _bcast(self, arr) -> np.ndarray:
        """Process 0's host array, on every process (same shape and dtype
        given everywhere)."""
        import torch.distributed as dist

        a = np.array(arr)
        is_bool = a.dtype == bool
        t = torch.from_numpy(a.view(np.uint8) if is_bool else a)
        dist.broadcast(t, src=0, group=self.mesh.ctrl_group)
        out = t.numpy()
        return out.view(bool) if is_bool else out

    def _header(self, *fields) -> None:
        hdr = np.zeros(6, np.int32)
        hdr[:len(fields)] = fields
        self._bcast(hdr)

    def search_dense(self, Q, qmask, k: int = 10, n_candidates=None):
        """Process 0's search: validate, announce, ship the queries, then
        search with the followers. Validation comes before the broadcasts:
        once the header is out every follower enters the same search."""
        if n_candidates and self.engine.summary is None:
            raise ValueError(
                "n_candidates requires a pruning summary index (construct "
                "the engine with prune_centroids>0)")
        Q = np.asarray(_host(Q), dtype=np.float32)
        qmask = np.asarray(_host(qmask), dtype=bool)
        if Q.ndim != 3 or qmask.shape != Q.shape[:2]:
            raise ValueError(f"queries {Q.shape} and mask {qmask.shape}")
        self._header(self.OP_SEARCH, *Q.shape, int(k),
                     int(n_candidates or 0))
        self._bcast(Q)
        self._bcast(qmask)
        return self.engine.search_dense(Q, qmask, k=k,
                                        n_candidates=n_candidates)

    # --- incremental mutations (frontend) --------------------------------
    # docid lists travel as one JSON blob of uint8 (any id strings; the
    # header carries its byte length so followers size the buffer)

    @staticmethod
    def _ids_blob(ids) -> np.ndarray:
        import json

        return np.frombuffer(json.dumps([str(d) for d in ids]).encode(
            "utf-8"), dtype=np.uint8)

    @staticmethod
    def _ids_unblob(blob: np.ndarray) -> list:
        import json

        return json.loads(bytes(bytearray(blob)).decode("utf-8"))

    def add(self, P_new, pmask_new, docids=None, normalize=None) -> int:
        """Broadcast, then add: every process appends the same rows to its
        host tail buffers; each builds its tail shards on the next
        search."""
        P_new = np.asarray(_host(P_new), dtype=np.float32)
        pm_new = np.asarray(_host(pmask_new), dtype=bool)
        # validate before the first broadcast: a shape error must stay a
        # frontend error (HTTP 400), since a follower's mutation that fails
        # stops it
        if P_new.ndim != 3 or P_new.shape[-1] != self.engine.dim:
            raise ValueError(
                f"add() embeddings must be (n, Lp, {self.engine.dim}); "
                f"got {P_new.shape}")
        if pm_new.shape != P_new.shape[:2]:
            raise ValueError(
                f"pmask shape {pm_new.shape} does not match docs "
                f"{P_new.shape[:2]}")
        if docids is not None:
            ids = [str(d) for d in docids]
            if len(ids) != P_new.shape[0] or len(set(ids)) != len(ids):
                raise ValueError(f"{len(ids)} docids (distinct: "
                                 f"{len(set(ids))}) for {P_new.shape[0]} "
                                 "docs")
        blob = (self._ids_blob(docids) if docids is not None
                else np.zeros(0, np.uint8))
        norm_code = -1 if normalize is None else int(bool(normalize))
        self._header(self.OP_ADD, *P_new.shape, int(blob.size), norm_code)
        self._bcast(P_new)
        self._bcast(pm_new)
        if blob.size:
            self._bcast(blob)
        return self.engine.add(
            P_new, pm_new, docids=docids,
            normalize=None if norm_code < 0 else bool(norm_code))

    def add_ragged(self, documents_obj, doc_attnmask=None, doc_imgmask=None,
                   docids=None) -> int:
        from evdr_tpu_torch.data.packing import preprocess_docs

        P, pmask, _ = preprocess_docs(documents_obj, doc_attnmask,
                                      doc_imgmask)
        return self.add(P, pmask, docids=docids)

    def delete(self, docids) -> int:
        blob = self._ids_blob(docids)
        self._header(self.OP_DELETE, int(blob.size))
        if blob.size:
            self._bcast(blob)
        return self.engine.delete([str(d) for d in docids])

    def compact(self):
        self._header(self.OP_COMPACT)
        self.engine.compact()
        return self

    def to_packed_payload(self) -> dict:
        """The rows gathered by every process; only process 0's payload is
        used (the server writes it outside its dispatch lock)."""
        self._header(self.OP_SNAPSHOT)
        return self.engine.to_packed_payload()

    @staticmethod
    def write_packed_npz(path, payload: dict) -> None:
        from evdr_tpu_torch.engine import RetrievalEngine

        RetrievalEngine.write_packed_npz(path, payload)

    def save_npz(self, path) -> None:
        self.write_packed_npz(path, self.to_packed_payload())

    def follow(self) -> None:
        """Follower loop (processes > 0): mirror process 0's calls until
        OP_STOP.

        A read (search, snapshot) that fails is logged and the loop goes
        on: process 0 makes the same call on the same inputs, fails the
        same way and answers its client, and a follower that died here
        would leave the next broadcast waiting for it for ever. A mutation
        (add, delete, compact) that fails stops the process: process 0
        validates before it broadcasts, so a failure here is this host's
        own (memory, disk), and carrying on with an engine that differs
        from process 0's would hang the next collective far from the
        cause."""
        mutating = (self.OP_ADD, self.OP_DELETE, self.OP_COMPACT)
        while True:
            hdr = self._bcast(np.zeros(6, dtype=np.int32))
            op, b, lq, d, k, nc = (int(x) for x in hdr)
            if op == self.OP_STOP:
                return
            try:
                if op == self.OP_SEARCH:
                    Q = self._bcast(np.zeros((b, lq, d), dtype=np.float32))
                    qm = self._bcast(np.zeros((b, lq), dtype=bool))
                    self.engine.search_dense(Q, qm, k=k,
                                             n_candidates=nc or None)
                elif op == self.OP_ADD:
                    # header: (op, n, lp, d, ids blob bytes, norm code)
                    P = self._bcast(np.zeros((b, lq, d), dtype=np.float32))
                    pm = self._bcast(np.zeros((b, lq), dtype=bool))
                    ids = (self._ids_unblob(
                        self._bcast(np.zeros(k, np.uint8))) if k else None)
                    self.engine.add(P, pm, docids=ids,
                                    normalize=None if nc < 0 else bool(nc))
                elif op == self.OP_DELETE:
                    ids = (self._ids_unblob(
                        self._bcast(np.zeros(b, np.uint8))) if b else [])
                    self.engine.delete(ids)
                elif op == self.OP_COMPACT:
                    self.engine.compact()
                elif op == self.OP_SNAPSHOT:
                    self.engine.to_packed_payload()  # the gathers
                else:
                    raise RuntimeError(f"unknown multihost opcode {op}")
            except Exception as e:
                if op in mutating:
                    print(f"[multihost follower] mutation op {op} failed; "
                          f"this process's state would differ from process "
                          f"0's, stopping: {type(e).__name__}: {e}",
                          file=sys.stderr, flush=True)
                    raise
                print(f"[multihost follower] op {op} failed (process 0 "
                      f"answers the client): {type(e).__name__}: {e}",
                      file=sys.stderr, flush=True)

    def stop(self) -> None:
        """Process 0: release the followers (at server shutdown)."""
        self._header(self.OP_STOP)


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x
