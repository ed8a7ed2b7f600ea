"""Doc-sharded multi-vector index.

Counterpart of ``evdr_tpu/parallel/sharded_index.py``. The doc axis is
padded to a multiple of ``n_shards * pad_docs_to`` (padded docs are fully
masked, so they score 0, and the valid count is tracked so top-k drops
them). On one device the index is the tensors ``P``, ``pmask``,
``scales`` and ``books``. On a mesh of several shards (``parallel/mesh.
DeviceMesh``) the shards are contiguous row ranges with the padding at the
end, as in the JAX package, so a global doc index names the same row in
both; ``parts`` holds the shards this process owns, each a one-device
``ShardedIndex`` on its device (int8/int4 scales shard with their docs,
PQ books are copied to every shard's device). A ``dp x docs`` mesh holds
the whole index on each dp group.

``streaming=True`` builds (``build_sharded_index``) copy a host array, such
as a read-only ``np.memmap`` of a packed file, into device tensors
allocated once at the padded size, a bounded chunk of rows at a time
(int8 quantized chunk by chunk), so a GB-scale file never lands whole in
anonymous host memory; on a mesh, one shard at a time. A mesh build reads
only the rows of the shards this process owns. ``as_tensor`` takes the
same route for any read-only array.

Block builds (``build_sharded_index_blocks``) take a corpus that no
process holds whole, as a function that gives any range of rows on a
given device: each shard fills its padded tensors from its own rows, a
block at a time, quantizing (int8) or quantizing and packing (int4) on
its own device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from evdr_tpu_torch.data.packing import l2_normalize
from evdr_tpu_torch.ops.cuda_maxsim import (D_GRANULE, pad_dim,
                                            pad_pq_queries, pq_width)
from evdr_tpu_torch.ops.int4 import packed_token_rows, quantize_tokens_int4
from evdr_tpu_torch.ops.quantize import quantize_tokens_int8
from evdr_tpu_torch.parallel.mesh import DeviceMesh
from evdr_tpu_torch.utils.timing import span

_FLOAT_DTYPES = {None: torch.float32, "float32": torch.float32,
                 "bfloat16": torch.bfloat16}
_QUANTIZERS = {"int8": (quantize_tokens_int8, torch.int8),
               "int4": (quantize_tokens_int4, torch.uint8)}


@dataclass
class ShardedIndex:
    # one device (a mesh of one): the tensors below; a mesh of several:
    # P, pmask and scales are None, ``parts`` holds this process's shards
    # and ``books`` the first shard's copy of the books
    # (N_pad, Lp, D) float32 / bfloat16 / int8 codes, (N_pad, ceil(Lp/2), D)
    # uint8 packed int4 codes, or (N_pad, Lp, M) uint8 PQ codes
    P: Optional[torch.Tensor]
    pmask: Optional[torch.Tensor]      # (N_pad, Lp) bool
    n_docs: int              # valid docs (<= N_pad)
    docids: Optional[np.ndarray] = None
    # int8 and int4 indexes: per-token f32 scales (N_pad, Lp); None otherwise
    scales: Optional[torch.Tensor] = None
    # product-quantized indexes: (M, K, D/M) compact or (M, K, D) expanded
    # f32 codebooks (ops/pq.py); P then holds the codes
    books: Optional[torch.Tensor] = None
    # True for full-width (M, K, D) OPQ codebooks (ops/pq.expand_books): the
    # two layouts cannot be told apart from the books alone (engine.dim)
    books_expanded: bool = False
    # the token dim D of the indexed pages, where the stored tokens (or PQ
    # books) were zero-padded wider for the kernels (pad_index_dim)
    dim: Optional[int] = None
    mesh: Optional[DeviceMesh] = None
    # this process's shards in ``mesh.local_shards()`` order, each a
    # one-device index of ``shard_rows`` rows whose n_docs counts its
    # valid rows
    parts: Optional[List["ShardedIndex"]] = None

    @property
    def n_pad(self) -> int:
        if self.parts is None:
            return int(self.P.shape[0])
        return self.shard_rows * self.mesh.n_doc_shards

    @property
    def shard_rows(self) -> int:
        if self.parts is None:
            return self.n_pad
        return int(self.parts[0].pmask.shape[0])

    @property
    def first(self) -> "ShardedIndex":
        """The one-device index whose tensors describe the layout (dtype,
        widths, books): the index itself, or its first shard."""
        return self if self.parts is None else self.parts[0]


# rows a streamed copy moves at a time: about this many host bytes
STREAM_CHUNK_BYTES = 64 << 20


def _host_tensor(x: np.ndarray) -> torch.Tensor:
    """A writable host array -> a CPU tensor sharing its memory (ml_dtypes
    bf16 reinterpreted from its bits)."""
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def _row_chunks(x):
    """(start, end) row ranges of ``x`` of about STREAM_CHUNK_BYTES each."""
    n = int(x.shape[0])
    row = max(1, int(np.prod(x.shape[1:], dtype=np.int64)) * x.itemsize)
    step = max(1, STREAM_CHUNK_BYTES // row)
    return [(s, min(n, s + step)) for s in range(0, n, step)]


def stream_rows(x, device, dtype=None, n_pad=None) -> torch.Tensor:
    """Host array (e.g. a read-only ``np.memmap``) -> a new tensor of
    ``n_pad`` rows (default: ``x``'s; the rest zero) on ``device``, filled
    a bounded chunk of rows at a time: host memory holds one chunk, never
    a copy of the whole array."""
    n = int(x.shape[0])
    n_pad = n if n_pad is None else int(n_pad)
    if dtype is None:
        dtype = _host_tensor(np.zeros((0,) + tuple(x.shape[1:]),
                                      x.dtype)).dtype
    out = torch.zeros((n_pad,) + tuple(x.shape[1:]), dtype=dtype,
                      device=device)
    for s, e in _row_chunks(x):
        out[s:e].copy_(_host_tensor(np.array(x[s:e])))
    return out


def as_tensor(x, device, dtype=None) -> torch.Tensor:
    """numpy array or tensor -> tensor on ``device``; a tensor already there
    with the right dtype is returned as is (no copy). A read-only array (a
    memory-mapped file, a view of a JAX array) is copied a chunk of rows at
    a time (:func:`stream_rows`), not whole."""
    if not isinstance(x, torch.Tensor):
        x = np.ascontiguousarray(x)
        if not x.flags.writeable:
            if x.ndim == 0:
                return as_tensor(x.copy(), device, dtype)
            return stream_rows(x, device, dtype)
        x = _host_tensor(x)
    return x.to(device=device, dtype=dtype)


def _pad_docs(x: torch.Tensor, n_pad: int) -> torch.Tensor:
    if x.shape[0] == n_pad:
        return x.contiguous()
    out = torch.zeros((n_pad,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    out[:x.shape[0]] = x
    return out


def _stream_quantized_int8(P, pmask, device, n_pad: int):
    """int8 codes + scales of host float tokens, quantized a bounded chunk
    of rows at a time (per-token scales make the chunking exact) into
    tensors allocated once at ``n_pad`` rows."""
    n, lp, d = (int(s) for s in P.shape)
    codes = torch.zeros((n_pad, lp, d), dtype=torch.int8, device=device)
    scales = torch.zeros((n_pad, lp), dtype=torch.float32, device=device)
    for s, e in _row_chunks(P):
        c, sc = quantize_tokens_int8(np.asarray(P[s:e], np.float32),
                                     np.asarray(pmask[s:e], bool))
        codes[s:e].copy_(torch.from_numpy(c))
        scales[s:e].copy_(torch.from_numpy(sc))
    return codes, scales


def _build_streamed(P, pmask, device, dtype, n_pad, scales, docids):
    """``build_sharded_index(..., streaming=True)``: every array streams
    from the host straight into its padded device tensor."""
    n = int(P.shape[0])
    if dtype == "int8" and scales is None:
        P_d, scales_d = _stream_quantized_int8(P, pmask, device, n_pad)
    elif dtype == "int4" and scales is None:
        # quantize-on-stream is not implemented (as in the JAX package):
        # pack the file (tools/convert_packed.py --dtype int4) instead
        raise ValueError("streaming int4 builds need pre-packed codes "
                         "+ scales (convert_packed --dtype int4)")
    else:
        if dtype in _QUANTIZERS:
            code_dtype = _QUANTIZERS[dtype][1]
        elif dtype is None and np.dtype(P.dtype) == np.uint8:
            code_dtype = torch.uint8
        else:
            code_dtype = _FLOAT_DTYPES[dtype]
        P_d = stream_rows(P, device, code_dtype, n_pad)
        scales_d = (None if scales is None
                    else stream_rows(scales, device, torch.float32, n_pad))
    return ShardedIndex(P=P_d,
                        pmask=stream_rows(pmask, device, torch.bool, n_pad),
                        n_docs=n, docids=docids, scales=scales_d)


def build_sharded_index(P, pmask, device, dtype=None, pad_docs_to: int = 64,
                        scales=None, docids=None,
                        streaming: bool = False) -> ShardedIndex:
    """Place an index on ``device``, or shard it over a ``DeviceMesh``.

    ``dtype`` stores it narrower: 'bfloat16' casts (round to nearest even),
    'int8' and 'int4' quantize per token (ops/quantize.py, ops/int4.py)
    unless ``scales`` are given, in which case ``P`` already holds the codes
    (int8, or token-pair packed uint8 for int4; packed files written with
    --normalize). ``P`` may be a numpy array or a tensor on any device;
    quantization runs where ``P`` lies. ``dtype=None`` keeps uint8 PQ codes
    as they are (``RetrievalEngine.build_from_pq`` adds the books).

    ``streaming=True`` (host arrays, e.g. memory-mapped packed files)
    allocates each device tensor once at the padded size and copies a
    bounded chunk of rows at a time into it, quantizing int8 chunk by
    chunk; an int4 build must then be given its packed codes + scales.

    On a mesh of several shards each shard this process owns is built
    from its own rows only (per-token quantization makes that exact), with
    the doc axis padded to a multiple of ``n_shards * pad_docs_to``.
    """
    if dtype not in (None, "float32", "bfloat16", "int8", "int4"):
        raise ValueError(f"unsupported index dtype {dtype!r}")
    quantum = max(1, int(pad_docs_to))
    n = int(P.shape[0])
    if isinstance(device, DeviceMesh):
        if device.size > 1:
            return _build_on_mesh(P, pmask, device, dtype, quantum, scales,
                                  docids, streaming)
        device = device.devices[0]
    n_pad = ((n + quantum - 1) // quantum) * quantum
    return _build_one(P, pmask, torch.device(device), dtype, n_pad, scales,
                      docids, streaming)


def _build_one(P, pmask, device, dtype, n_pad, scales, docids, streaming):
    """One device's index of ``n_pad`` rows (the valid rows first)."""
    n = int(P.shape[0])
    if streaming:
        return _build_streamed(P, pmask, device, dtype, n_pad, scales,
                               docids)
    if dtype in _QUANTIZERS:
        quantize, code_dtype = _QUANTIZERS[dtype]
        if scales is None:
            P, scales = quantize(P, pmask)
        P = as_tensor(P, device, code_dtype)
        scales = _pad_docs(as_tensor(scales, device, torch.float32), n_pad)
    else:
        if scales is not None:
            raise ValueError("scales are given only with dtype='int8' or "
                             "'int4'")
        keep = P.dtype == torch.uint8 if isinstance(P, torch.Tensor) \
            else np.asarray(P).dtype == np.uint8
        P = as_tensor(P, device, torch.uint8 if (dtype is None and keep)
                      else _FLOAT_DTYPES[dtype])
    return ShardedIndex(
        P=_pad_docs(P, n_pad),
        pmask=_pad_docs(as_tensor(pmask, device, torch.bool), n_pad),
        n_docs=n,
        docids=docids,
        scales=scales,
    )


def shard_range(rows: int, col: int, n_docs: int):
    """Rows [lo, hi) of the corpus that doc shard ``col`` of ``rows`` rows
    holds (clipped to ``n_docs``; the shard's other rows are padding)."""
    rows = int(rows)
    lo = min(col * rows, n_docs)
    return lo, min(lo + rows, n_docs)


def _build_on_mesh(P, pmask, mesh, dtype, quantum, scales, docids,
                   streaming) -> ShardedIndex:
    if streaming and mesh.dp > 1:
        # as the JAX package: a dp-replicated stream would read every row
        # once per group
        raise ValueError("streaming builds support 1D doc meshes only; "
                         "load eagerly or use a 1D mesh")
    n = int(P.shape[0])
    q = mesh.n_doc_shards * quantum
    n_pad = ((n + q - 1) // q) * q
    rows = n_pad // mesh.n_doc_shards
    parts = []
    for _, col, dev in mesh.local_shards():
        lo, hi = shard_range(rows, col, n)
        parts.append(_build_one(
            P[lo:hi], pmask[lo:hi], dev, dtype, rows,
            None if scales is None else scales[lo:hi], None, streaming))
    return ShardedIndex(P=None, pmask=None, n_docs=n, docids=docids,
                        mesh=mesh, parts=parts)


# rows a block build asks its source for at a time
BLOCK_ROWS = 1024


def build_sharded_index_blocks(source, n_docs: int, device, dtype=None,
                               pad_docs_to: int = 64, docids=None,
                               normalize: bool = False) -> ShardedIndex:
    """Build an index from a corpus that no process holds whole:
    ``source(lo, hi, device)`` gives the float tokens (hi - lo, Lp, D) and
    the bool mask (hi - lo, Lp) of rows ``[lo, hi)``, on ``device``.

    Each shard this process owns (or the one device) allocates its padded
    tensors once on its device and fills them at most ``BLOCK_ROWS`` rows
    at a time, each block normalized (``normalize``) and quantized (int8),
    quantized and packed (int4) or cast (bfloat16, float32) there. Blocks
    go to the shards in turn with no host sync, so the shards' devices
    build at once. The rows and padding are laid out as
    :func:`build_sharded_index` lays them out for the whole array, and
    per-token quantization makes the result bit-equal to it: int4 packs
    token pairs within a page, so a block of whole pages packs alone."""
    if dtype not in (None, "float32", "bfloat16", "int8", "int4"):
        raise ValueError(f"a block build takes dtype None, 'float32', "
                         f"'bfloat16', 'int8' or 'int4', not {dtype!r}")
    n = int(n_docs)
    if n < 1:
        raise ValueError("a block build needs at least one doc")
    quantum = max(1, int(pad_docs_to))
    mesh = device if isinstance(device, DeviceMesh) else None
    if mesh is not None and mesh.size == 1:
        mesh, device = None, mesh.devices[0]
    if mesh is None:
        rows = ((n + quantum - 1) // quantum) * quantum
        shards = [(0, n, torch.device(device))]
    else:
        q = mesh.n_doc_shards * quantum
        rows = ((n + q - 1) // q) * q // mesh.n_doc_shards
        shards = [shard_range(rows, col, n) + (dev,)
                  for _, col, dev in mesh.local_shards()]
    step = BLOCK_ROWS
    parts = [None] * len(shards)
    todo = [[(s, min(s + step, hi)) for s in range(lo, hi, step)]
            for lo, hi, _ in shards]
    layout = None
    for j in range(max(len(t) for t in todo)):
        for i, (lo, _, dev) in enumerate(shards):
            if j >= len(todo[i]):
                continue
            s, e = todo[i][j]
            with span("evdr.index.build_block"):
                Pb, mb = source(s, e, dev)
                Pb = as_tensor(Pb, dev, torch.float32)
                mb = as_tensor(mb, dev, torch.bool)
                if layout is None:
                    layout = tuple(Pb.shape[1:])
                if (tuple(Pb.shape) != (e - s,) + layout
                        or tuple(mb.shape) != (e - s, layout[0])):
                    raise ValueError(
                        f"source({s}, {e}) gave tokens {tuple(Pb.shape)} "
                        f"and mask {tuple(mb.shape)}; want "
                        f"{(e - s,) + layout} and {(e - s, layout[0])}")
                if parts[i] is None:
                    parts[i] = _empty_shard(rows, layout, dev, dtype)
                _fill_block(parts[i], s - lo, Pb, mb, dtype, normalize)
    for i, (lo, hi, dev) in enumerate(shards):
        if parts[i] is None:
            # a shard past the last doc: padding only
            parts[i] = _empty_shard(rows, layout, dev, dtype)
        parts[i].n_docs = hi - lo
    if mesh is None:
        parts[0].docids = docids
        return parts[0]
    return ShardedIndex(P=None, pmask=None, n_docs=n, docids=docids,
                        mesh=mesh, parts=parts)


def _empty_shard(rows: int, layout, device, dtype) -> ShardedIndex:
    """A shard of ``rows`` padding rows (masked, zero tokens and scales):
    (rows, Lp, D) codes or float tokens, or (rows, ceil(Lp/2), D) packed
    int4 codes."""
    lp, d = layout
    quantized = dtype in _QUANTIZERS
    code = _QUANTIZERS[dtype][1] if quantized else _FLOAT_DTYPES[dtype]
    width = packed_token_rows(lp) if dtype == "int4" else lp
    return ShardedIndex(
        P=torch.zeros((rows, width, d), dtype=code, device=device),
        pmask=torch.zeros((rows, lp), dtype=torch.bool, device=device),
        n_docs=0,
        scales=(torch.zeros((rows, lp), dtype=torch.float32, device=device)
                if quantized else None))


def _fill_block(part: ShardedIndex, at: int, Pb, mb, dtype, normalize):
    """Rows ``[at, at + len(Pb))`` of ``part`` from float tokens ``Pb``."""
    if normalize:
        Pb = l2_normalize(Pb * mb[..., None])
    e = at + int(Pb.shape[0])
    if dtype in _QUANTIZERS:
        codes, scales = _QUANTIZERS[dtype][0](Pb, mb)
        part.P[at:e].copy_(codes)
        part.scales[at:e].copy_(scales)
    else:
        part.P[at:e].copy_(Pb)
    part.pmask[at:e].copy_(mb)


def set_books(index: ShardedIndex, books, expanded: bool) -> ShardedIndex:
    """Give a PQ index its f32 codebooks, copied to every shard's device."""
    copies = {}
    for part in ([index] if index.parts is None else index.parts):
        dev = part.pmask.device
        if dev not in copies:
            copies[dev] = as_tensor(books, dev, torch.float32).contiguous()
        part.books, part.books_expanded = copies[dev], bool(expanded)
    index.books = index.first.books
    index.books_expanded = bool(expanded)
    return index


def pad_index_dim(index: ShardedIndex) -> ShardedIndex:
    """Zero-pad the stored token dim once, up to the width the kernels take
    (a multiple of ``D_GRANULE``), and record the true dim
    in ``index.dim``. Zero lanes add nothing to a similarity, so the scores
    are those of the true dim. Quantized codes are padded after
    quantization (their scales are those of the true tokens); compact PQ
    books pad each subspace's rows (``cuda_maxsim.pq_width``) and expanded
    OPQ books their last axis. Queries meet the index through
    :func:`pad_queries`."""
    if index.dim is not None:
        return index
    if index.parts is not None:
        for part in index.parts:
            pad_index_dim(part)
        index.dim = index.first.dim
        index.books = index.first.books
        return index

    def width(d):
        return -(-d // D_GRANULE) * D_GRANULE

    b = index.books
    if b is None:
        d = int(index.P.shape[-1])
        index.P = pad_dim(index.P, width(d)).contiguous()
    elif index.books_expanded:
        d = int(b.shape[-1])
        index.books = pad_dim(b, width(d)).contiguous()
    else:
        m, w = int(b.shape[0]), int(b.shape[-1])
        d = m * w
        index.books = pad_dim(b, pq_width(m, w)).contiguous()
    index.dim = d
    return index


def pad_queries(Q: torch.Tensor, index: ShardedIndex) -> torch.Tensor:
    """(nq, Lq, D) queries at the index's true dim -> the stored width of
    :func:`pad_index_dim` (zeros; per subspace for compact PQ books).
    Queries of any other width pass unchanged, for the scorer to refuse."""
    index = index.first
    d = index.dim
    if d is None or Q.shape[-1] != d:
        return Q
    b = index.books
    if b is not None and not index.books_expanded:
        m = int(b.shape[0])
        return pad_pq_queries(Q, m, d // m, int(b.shape[-1]))
    width = int((b if b is not None else index.P).shape[-1])
    return pad_dim(Q, width)
