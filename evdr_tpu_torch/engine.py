"""RetrievalEngine — the user-facing multi-vector retrieval API on a GPU.

Loads (or receives) a page-embedding index, places it on one device or
shards it over a doc mesh (``parallel/mesh.py``: several GPUs, a
``dp x docs`` grid, or one GPU per process across ``torch.distributed``,
``parallel/multihost.py``), and serves MaxSim top-k queries through the
fused CUDA kernels:

    engine = RetrievalEngine.from_npz("features/tabfquad_dump_all.npz")
    docids, scores = engine.search(query_token_arrays, k=10)

The engine runs on ``cuda`` unless the caller passes ``device="cpu"``; with
no GPU present it raises instead of carrying on on the CPU. On the CPU every
kernel is replaced by its plain PyTorch version (``impl`` reports which).

Storage dtypes: float32, bfloat16, int8, int4 (token-pair packed nibbles +
per-token scales) and pq (product-quantized codes + codebooks, optionally
OPQ-rotated). A float32 engine scores through the bf16 kernel, like the TPU
engine's Pallas path. ``prune_centroids > 0`` also builds a per-page
summary index for two-stage pruned search (``search_dense(...,
n_candidates=C)``, ``ops/pruned.py``).

Incremental serving: ``add`` / ``add_ragged`` queue new pages for a small
tail index (built lazily on the next search, same storage dtype, PQ
encoded against the main index's books) that every search scores beside
the main index; ``delete`` tombstones docs (a device-side alive mask);
``compact`` folds both into a new main index; ``save_npz`` writes the
current corpus as a packed file that either package loads.
``from_npz(mmap=True)`` streams a packed file's memory-mapped arrays to
the device a bounded chunk at a time.

On a mesh of several shards every shard scores its rows through the same
kernels and the candidates merge exactly (``parallel/topk.py``); pruned
search reranks each shard's candidates where they lie, and incremental
serving merges the tail by over-fetching the main index (as the JAX
package's mesh branch). Across processes every search, add, delete,
compact and snapshot is a collective that every process enters with the
same inputs (``multihost.MultihostSearchCoordinator`` drives them).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from evdr_tpu_torch.data.npz_io import load_payload
from evdr_tpu_torch.data.packing import (l2_normalize, preprocess_docs,
                                         preprocess_queries)
from evdr_tpu_torch.parallel.sharded_index import (ShardedIndex, as_tensor,
                                                   build_sharded_index,
                                                   pad_index_dim, pad_queries,
                                                   set_books)
from evdr_tpu_torch.parallel.topk import (_mesh_topk,
                                          _single_device_merged_topk,
                                          sharded_maxsim, sharded_rerank,
                                          sharded_topk)
from evdr_tpu_torch.utils.timing import span

DTYPES = (None, "float32", "bfloat16", "int8", "int4", "pq")
SUMMARY_DTYPES = (None, "bfloat16", "float32", "int8", "int4")


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU. Asking for a GPU where there is none raises:
    nothing falls back to the CPU unless the caller asked for it."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch path on the host")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


class RetrievalEngine:
    def __init__(self, dtype: Optional[str] = "bfloat16", impl: str = "auto",
                 normalize: bool = True, prune_centroids: int = 0,
                 quantize_queries: bool = False, pq_m: int = 16,
                 pq_opq: bool = False, summary_dtype: Optional[str] = None,
                 device=None, mesh=None):
        """``dtype='int8'`` stores the index quantized (ops/quantize.py,
        half the bytes of bf16); adding ``quantize_queries=True`` also
        quantizes queries on the device so scoring runs int8 x int8
        (impl 'cuda_q8').

        ``dtype='int4'`` packs two 4-bit codes per byte + per-token scales
        (ops/int4.py): half of int8's bytes. ``dtype='pq'`` product-
        quantizes the index (ops/pq.py): ``pq_m`` bytes per token, 8x below
        int8 at D=128, M=16, lossy; ``pq_opq=True`` learns an OPQ rotation
        at build time, folded into expanded codebooks. ``quantize_queries``
        selects int8 x int8 scoring for int4 and pq too, but not for pq with
        ``pq_opq``: the int8 x int8 tile needs compact books (with expanded
        books the quantized queries would only cast back up to bf16, at
        the same cost and with more error).

        ``mesh`` (``parallel/mesh.DeviceMesh``) shards the index over its
        doc shards instead of placing it on ``device``; a device alone is
        a mesh of one, and a mesh of one takes the one-device path.

        ``impl`` is 'auto' or the name it resolves to: 'cuda' on a GPU,
        'plain' (the kernels' plain versions) on the CPU, with '_q8' for
        quantized queries.

        ``prune_centroids > 0`` also builds a summary index of that many
        per-page k-means centres (``build``, and ``from_npz`` of a PQ
        file): ``search_dense(..., n_candidates=C)`` then scores the
        summaries first (stage 1, the serving kernels at Lp =
        prune_centroids) and reranks only C candidate pages per query
        exactly (stage 2). ``summary_dtype`` is the summaries' storage
        tier: default the engine's dtype (bfloat16 for PQ engines: stage
        1 has no books); 'int8' / 'int4' score stage 1 through the
        quantized kernels."""
        if dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {DTYPES}, got {dtype!r}")
        if summary_dtype not in SUMMARY_DTYPES:
            raise ValueError(
                f"summary_dtype={summary_dtype!r} unsupported: the summary "
                "stage scores dense tokens (bfloat16/float32/int8/int4)")
        if mesh is not None:
            devs = {resolve_device(d) for d in mesh.devices}
            if len({d.type for d in devs}) != 1:
                raise ValueError(f"a mesh of one device type: {devs}")
            if device is not None and resolve_device(device) not in devs:
                raise ValueError(f"device {device} is not on the mesh")
            device = mesh.devices[0]
        self.device = resolve_device(device)
        self.mesh = mesh
        # a mesh of several shards (or processes) takes the mesh branches
        self._sharded = mesh is not None and mesh.size > 1
        self.dtype = dtype
        self.normalize = normalize
        self.pq_m = pq_m
        self.pq_opq = pq_opq
        self.prune_centroids = prune_centroids
        self.summary_dtype = summary_dtype
        base = "cuda" if self.device.type == "cuda" else "plain"
        if impl not in ("auto", base):
            raise ValueError(f"impl={impl!r} on {self.device}: use 'auto' "
                             f"or {base!r}")
        q8 = (quantize_queries and dtype in ("int8", "int4", "pq")
              and not (dtype == "pq" and pq_opq))
        self.impl = base + ("_q8" if q8 else "")
        self.index: Optional[ShardedIndex] = None
        self.summary: Optional[ShardedIndex] = None
        # incremental updates: add() appends host float pages to
        # _tail_parts (O(batch)); the next search folds them into
        # _tail_P/_tail_pm and builds the device TAIL index from them
        # (_ensure_tail), so a burst of adds pays one rebuild. Deletions
        # are tombstoned global indices (main rows first, then tail rows),
        # masked on the device by _alive, rebuilt only when they change.
        self._reset_incremental()

    def _reset_incremental(self) -> None:
        """A (re)build supersedes any incremental state: stale tails or
        tombstones of a previous corpus must not leak into the new one."""
        self.tail: Optional[ShardedIndex] = None
        self._tail_P: Optional[np.ndarray] = None
        self._tail_pm: Optional[np.ndarray] = None
        self._tail_parts: list = []
        self._tail_dirty = False
        self._tail_ids: list = []
        self._tombstones: set = set()
        self._next_auto_id: Optional[int] = None
        self._docid_lut_cache: Optional[dict] = None
        self._alive: Optional[torch.Tensor] = None

    def _sdtype(self) -> str:
        """Storage tier of the pruning summary index: ``summary_dtype``,
        else the engine dtype (bfloat16 for PQ: stage 1 has no books)."""
        if self.summary_dtype is not None:
            return self.summary_dtype
        return "bfloat16" if self.dtype == "pq" else self.dtype

    def _build_summary(self, S, smask) -> None:
        self.summary = self._build_index(S, smask, dtype=self._sdtype())

    @property
    def _place(self):
        """Where indexes go: the mesh of several shards, or the device."""
        return self.mesh if self._sharded else self.device

    def _build_index(self, P, pmask, docids=None, dtype=None, scales=None,
                     streaming: bool = False) -> ShardedIndex:
        # on a mesh across processes each process builds (and so reads,
        # from a memory-mapped file) only its own shards' rows
        return pad_index_dim(build_sharded_index(
            P, pmask, self._place, dtype=dtype, scales=scales,
            docids=_ids(docids), streaming=streaming))

    # ------------------------------------------------------------------ build
    def build(self, P, pmask, docids: Optional[Sequence[str]] = None,
              normalize: Optional[bool] = None,
              streaming: bool = False) -> "RetrievalEngine":
        """Index dense padded page embeddings ``(N, Lp, D)`` + bool mask.

        ``P`` may be a numpy array or a tensor (normalized where it lies).
        ``normalize`` overrides the engine default for THIS build only.
        ``streaming=True`` copies host arrays (e.g. memory-mapped) to the
        device a bounded chunk at a time, with no whole host copy; it
        needs pre-normalized input (normalize False), no pruning summary
        and a non-pq dtype, each of which touches the whole array."""
        self._reset_incremental()
        normalize = self.normalize if normalize is None else normalize
        if streaming and not (normalize is False
                              and self.prune_centroids == 0
                              and self.dtype != "pq"):
            raise ValueError("streaming build needs normalize=False, "
                             "prune_centroids=0 and a non-pq dtype (each "
                             "touches the full array)")
        if isinstance(P, torch.Tensor):
            pmask = as_tensor(pmask, P.device, torch.bool)
            if normalize:
                P = l2_normalize(P.float() * pmask[..., None])
        elif not streaming:
            P = np.asarray(P, dtype=np.float32)
            pmask = np.asarray(pmask, dtype=bool)
            if normalize:
                P = np.asarray(l2_normalize(P * pmask[..., None]),
                               dtype=np.float32)
        if self.dtype == "pq":
            from evdr_tpu_torch.ops.pq import build_pq_index

            codes, books = build_pq_index(P, pmask, m=self.pq_m,
                                          opq=self.pq_opq, device=self.device)
            self.build_from_pq(codes, books, pmask, docids=docids,
                               expanded=self.pq_opq)
        else:
            self.index = self._build_index(P, pmask, docids=docids,
                                           dtype=self.dtype,
                                           streaming=streaming)
        if self.prune_centroids > 0:
            from evdr_tpu_torch.ops.pruned import build_summary_tokens

            self._build_summary(*build_summary_tokens(
                P, pmask, self.prune_centroids, device=self.device))
        return self

    def build_from_codes(self, codes, scales, pmask,
                         docids: Optional[Sequence[str]] = None,
                         streaming: bool = False) -> "RetrievalEngine":
        """Index pre-quantized int8 codes + per-token scales directly (no
        dequantize/renormalize/requantize round trip). Codes must come from
        normalized embeddings (packed files written with --normalize);
        with ``streaming=True`` a memory-mapped file streams to the device
        a bounded chunk at a time."""
        self._reset_incremental()
        if self.dtype != "int8":
            raise ValueError("build_from_codes requires dtype='int8'")
        self.index = self._build_index(codes, pmask, docids=docids,
                                       dtype="int8", scales=scales,
                                       streaming=streaming)
        return self

    def build_from_codes4(self, packed, scales, pmask,
                          docids: Optional[Sequence[str]] = None,
                          streaming: bool = False) -> "RetrievalEngine":
        """Index pre-packed int4 codes (N, ceil(Lp/2), D) uint8 + per-token
        scales directly (tools/convert_packed.py --dtype int4 --normalize),
        with no unpack/requantize round trip; memory-mapped files stream
        with ``streaming=True``."""
        self._reset_incremental()
        if self.dtype != "int4":
            raise ValueError("build_from_codes4 requires dtype='int4'")
        self.index = self._build_index(packed, pmask, docids=docids,
                                       dtype="int4", scales=scales,
                                       streaming=streaming)
        return self

    def build_from_pq(self, codes, books, pmask,
                      docids: Optional[Sequence[str]] = None,
                      expanded: bool = False) -> "RetrievalEngine":
        """Index pre-trained PQ codes (N, Lp, M) uint8 + codebooks directly
        (ops/pq.py; packed files written with --dtype pq).

        ``expanded=True`` marks full-width (M, K, D) OPQ codebooks
        (ops/pq.expand_books). The scorers tell the layouts apart from the
        query dim, but ``pad_index_dim`` (which pads the books and records
        ``dim``, with no query in hand) reads the recorded
        ``index.books_expanded`` flag."""
        self._reset_incremental()
        if self.dtype != "pq":
            raise ValueError("build_from_pq requires dtype='pq'")
        if not self._sharded:
            codes = as_tensor(codes, self.device, torch.uint8)
        # on a mesh each shard reads its own rows of the codes (a memory-
        # mapped file streams) and takes a copy of the books
        self.index = pad_index_dim(set_books(build_sharded_index(
            codes, pmask, self._place, docids=_ids(docids)), books,
            expanded))
        return self

    def build_from_ragged(self, documents_obj, doc_attnmask=None,
                          doc_imgmask=None, docids=None) -> "RetrievalEngine":
        P, pmask, _ = preprocess_docs(documents_obj, doc_attnmask, doc_imgmask)
        return self.build(P, pmask, docids)

    @classmethod
    def from_index(cls, P, pmask, n_docs: int, scales=None, docids=None,
                   books=None, books_expanded: bool = False,
                   **kw) -> "RetrievalEngine":
        """Serve an index that already exists as arrays: the (padded)
        arrays of a JAX ``ShardedIndex`` (``np.asarray(eng.index.P)``, ...)
        or tensors, used as stored (see ``evdr_tpu_torch.convert``); on a
        mesh each shard takes its rows."""
        from evdr_tpu_torch.convert import index_from_numpy

        eng = cls(**kw)
        eng._reset_incremental()
        eng.index = pad_index_dim(index_from_numpy(
            P, pmask, n_docs, scales=scales, docids=docids, books=books,
            books_expanded=books_expanded, device=eng._place))
        return eng

    # ---------------------------------------------------------- incremental
    def add(self, P_new, pmask_new, docids: Optional[Sequence[str]] = None,
            normalize: Optional[bool] = None) -> int:
        """Append documents without rebuilding the main index.

        New pages wait in host float buffers; the next search builds them
        into a small device tail index (same storage dtype; a PQ tail is
        encoded against the main index's books, expanded OPQ books
        included) that every search scores and merges exactly. ``add``
        itself is O(batch), so a burst of adds pays one tail rebuild.
        :meth:`compact` folds the tail into the main index.

        Adding an EXISTING docid is an upsert: the old row is tombstoned in
        the same call, so searches and ``delete`` see one row per id.
        Auto-assigned ids (no ``docids``) never collide with live ids.
        Returns the number of docs added."""
        if self.index is None:
            raise RuntimeError("add() needs a built index; call build()")
        normalize = self.normalize if normalize is None else normalize
        P_new = np.asarray(_host(P_new), dtype=np.float32)
        pm_new = np.asarray(_host(pmask_new), dtype=bool)
        # validate BEFORE mutating: the tail is built lazily, so a
        # malformed batch accepted here would fail every later search,
        # compact and save (through the server: one bad POST /add)
        if P_new.ndim != 3 or P_new.shape[-1] != self.dim:
            raise ValueError(
                f"add() embeddings must be (n, Lp, {self.dim}); "
                f"got {P_new.shape}")
        if pm_new.shape != P_new.shape[:2]:
            raise ValueError(
                f"pmask shape {pm_new.shape} does not match docs "
                f"{P_new.shape[:2]}")
        if normalize:
            P_new = np.asarray(
                l2_normalize(P_new * pm_new[..., None].astype(np.float32)),
                dtype=np.float32)
        n_new = P_new.shape[0]
        lut = self._docid_lut()
        if docids is not None:
            ids = [str(d) for d in docids]
            if len(ids) != n_new:
                raise ValueError(f"{len(ids)} docids for {n_new} docs")
            if len(set(ids)) != len(ids):
                raise ValueError("duplicate docids within one add()")
            # upsert: the old row of an existing id is superseded
            for d in ids:
                old = lut.get(d)
                if old is not None:
                    self._tombstones.add(old)
        else:
            # positional ids survive compaction's renumbering, so the
            # counter starts once past the largest live numeric id and
            # stays monotonic
            if self._next_auto_id is None:
                mx = self.index.n_docs + len(self._tail_ids) - 1
                for s in lut:
                    if s.isdigit():
                        mx = max(mx, int(s))
                self._next_auto_id = mx + 1
            ids = []
            nxt = self._next_auto_id
            while len(ids) < n_new:
                if str(nxt) not in lut:
                    ids.append(str(nxt))
                nxt += 1
            self._next_auto_id = nxt
        # the id map stays current: each new id maps to its tail row (an
        # upserted id to its new row), so add() stays O(batch)
        base = self.index.n_docs + len(self._tail_ids)
        for j, d in enumerate(ids):
            lut[d] = base + j
        self._tail_parts.append((P_new, pm_new))
        self._tail_ids.extend(ids)
        self._tail_dirty = True
        self._alive = None
        return n_new

    def add_ragged(self, documents_obj, doc_attnmask=None, doc_imgmask=None,
                   docids=None) -> int:
        P, pmask, _ = preprocess_docs(documents_obj, doc_attnmask,
                                      doc_imgmask)
        return self.add(P, pmask, docids=docids)

    def _consolidate_tail(self) -> None:
        """Fold pending add() batches into the contiguous tail buffers,
        padding every batch to the longest Lp (one concatenation per burst
        of adds, not one per add)."""
        if not self._tail_parts:
            return
        parts = ([] if self._tail_P is None
                 else [(self._tail_P, self._tail_pm)]) + self._tail_parts
        lp = max(p.shape[1] for p, _ in parts)
        self._tail_P = np.concatenate([_pad_tokens(p, lp, 0.0)
                                       for p, _ in parts], axis=0)
        self._tail_pm = np.concatenate([_pad_tokens(m, lp, False)
                                        for _, m in parts], axis=0)
        self._tail_parts = []

    def _ensure_tail(self) -> None:
        """Build the device tail from pending adds (lazily: the cost of a
        burst of add() calls lands on the first search after it)."""
        if self._tail_dirty:
            self._consolidate_tail()
            self._rebuild_tail()
            self._tail_dirty = False

    def _rebuild_tail(self) -> None:
        """The tail index on the engine's device, in its storage dtype,
        through the build path (docs padded to 64, D to the kernels'
        width as the main index's). PQ tails encode with the main books at
        their true width and carry the main index's padded books: compact
        books on the engine's device, expanded OPQ books by the host
        encoder, as the reference."""
        P = as_tensor(self._tail_P, self.device, torch.float32)
        pm = as_tensor(self._tail_pm, self.device, torch.bool)
        if self.dtype == "pq":
            from evdr_tpu_torch.ops.pq import (encode_pq_device,
                                               encode_with_books)

            ix = self.index
            books = self._true_books().cpu().numpy()
            if ix.books_expanded:
                codes = encode_with_books(self._tail_P, books, self._tail_pm)
            else:
                codes = encode_pq_device(P, books, pm)
            tail = build_sharded_index(codes, pm, self._place)
            # the main index's padded books, shard by shard
            for tp, mp in zip([tail] if tail.parts is None else tail.parts,
                              [ix] if ix.parts is None else ix.parts):
                tp.books, tp.books_expanded = mp.books, mp.books_expanded
                tp.dim = mp.dim
            tail.books, tail.books_expanded = ix.books, ix.books_expanded
            tail.dim = ix.dim
        else:
            tail = self._build_index(P, pm, dtype=self.dtype)
        self.tail = tail
        self._alive = None

    def _true_books(self) -> torch.Tensor:
        """The PQ books at their true width (``pad_index_dim`` pads them
        for the kernels: compact books per subspace, expanded ones on the
        last axis)."""
        ix = self.index
        if ix.books_expanded:
            return ix.books[..., :ix.dim]
        return ix.books[..., :ix.dim // int(ix.books.shape[0])]

    def _docid_lut(self) -> dict:
        if self._docid_lut_cache is None:
            n_main = self.index.n_docs
            if self.index.docids is not None:
                lut = {str(d): i for i, d in
                       enumerate(self.index.docids[:n_main])}
            else:
                lut = {str(i): i for i in range(n_main)}
            for j, d in enumerate(self._tail_ids):
                lut[str(d)] = n_main + j
            self._docid_lut_cache = lut
        return self._docid_lut_cache

    def delete(self, docids: Sequence[str]) -> int:
        """Tombstone documents by docid: they stop appearing in search
        results at once (masked at the merge; the stored rows stay until
        :meth:`compact`). Returns how many were newly deleted; unknown
        docids are ignored."""
        if self.index is None:
            raise RuntimeError("delete() needs a built index")
        lut = self._docid_lut()
        removed = 0
        for d in docids:
            i = lut.get(str(d))
            if i is not None and i not in self._tombstones:
                self._tombstones.add(i)
                removed += 1
        if removed:
            self._alive = None
        return removed

    def _alive_mask(self) -> torch.Tensor:
        """(n_main + n_tail) bool on the device, False at tombstones; kept
        until add, delete or compact changes it."""
        if self._alive is None:
            n = self.index.n_docs + (0 if self.tail is None
                                     else self.tail.n_docs)
            alive = torch.ones(n, dtype=torch.bool, device=self.device)
            if self._tombstones:
                alive[torch.as_tensor(sorted(self._tombstones),
                                      device=self.device)] = False
            self._alive = alive
        return self._alive

    def _materialize_rows(self):
        """Host (P_or_codes, pmask, scales or None, docids) of the CURRENT
        corpus: main + tail rows minus tombstones, token widths unified,
        tokens cut back to ``index.dim`` (bf16 tokens as uint16 bits).
        Shared by compact() and save_npz(); an O(corpus) fetch."""
        self._ensure_tail()
        n_main = self.index.n_docs
        n_tail = 0 if self.tail is None else self.tail.n_docs
        keep = np.array([i for i in range(n_main + n_tail)
                         if i not in self._tombstones], np.int64)
        ids = [r[0] for r in self.ids_for(keep[:, None])]
        Pm, pmm, scm = _fetch_rows(self.index)
        if not n_tail:
            return Pm[keep], pmm[keep], None if scm is None else scm[keep], ids
        Pt, pmt, sct = _fetch_rows(self.tail)
        lp = max(pmm.shape[1], pmt.shape[1])
        if self.dtype == "int4":
            # token-pair packed codes cannot be padded when the shorter
            # side's Lp is odd (the new token would share its byte):
            # unpack, pad, repack; exact, since requantizing an int4 grid
            # with its own per-token scale gives back the codes
            from evdr_tpu_torch.ops.int4 import (quantize_tokens_int4,
                                                 unpack_int4)

            def repack(codes, pm_, sc_):
                dec = unpack_int4(codes, lp=pm_.shape[1]).astype(
                    np.float32) * sc_[..., None]
                return quantize_tokens_int4(_pad_tokens(dec, lp, 0.0),
                                            _pad_tokens(pm_, lp, False))

            if pmm.shape[1] != pmt.shape[1]:
                Pm, scm = repack(Pm, pmm, scm)
                Pt, sct = repack(Pt, pmt, sct)
        else:
            Pm, Pt = _pad_tokens(Pm, lp, 0), _pad_tokens(Pt, lp, 0)
        pmm, pmt = _pad_tokens(pmm, lp, False), _pad_tokens(pmt, lp, False)
        P = np.concatenate([Pm, Pt], axis=0)[keep]
        pm = np.concatenate([pmm, pmt], axis=0)[keep]
        sc = (None if scm is None else np.concatenate(
            [_pad_tokens(scm, lp, 0.0), _pad_tokens(sct, lp, 0.0)],
            axis=0)[keep])
        return P, pm, sc, ids

    def to_packed_payload(self) -> dict:
        """The CURRENT corpus (tail merged, tombstones dropped) as a
        packed-npz dict (tools/convert_packed.py format): ``from_npz`` on
        an engine of the same dtype, in either package, serves exactly
        this index (codes consumed as stored, no requantization)."""
        if self.index is None:
            raise RuntimeError("to_packed_payload() needs a built index")
        P, pm, sc, ids = self._materialize_rows()
        # the stored rows are the serving representation: loaders take
        # them as they are, which is what the normalized marker means
        out = {"pmask": pm, "docid": np.asarray([str(i) for i in ids]),
               "doc_normalized": np.asarray(True)}
        if self.dtype == "pq":
            out["P_pq_codes"] = P
            out["P_pq_books"] = self._true_books().cpu().numpy()
            if self.index.books_expanded:
                out["P_pq_expanded"] = np.asarray(True)
        elif self.dtype == "int8":
            out["P_codes"], out["P_scale"] = P, sc
        elif self.dtype == "int4":
            out["P_codes4"], out["P_scale"] = P, sc
        elif self.dtype == "bfloat16":
            out["P_pad_bf16"] = P              # bf16 bits, as ml_dtypes'
        else:
            out["P_pad"] = np.asarray(P, np.float32)
        return out

    @staticmethod
    def write_packed_npz(path, payload: dict) -> None:
        """Atomic packed-npz write (a temporary file, then a rename; the
        temporary is removed if the write fails). Apart from
        :meth:`save_npz` so a server can take the payload under its
        dispatch lock and write it outside."""
        import os

        tmp = str(path) + ".tmp.npz"
        try:
            np.savez(tmp, **payload)
            os.replace(tmp, str(path))
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def save_npz(self, path) -> None:
        """Write the current corpus as a packed npz (see
        :meth:`to_packed_payload`), atomically. Across processes a
        collective (every process gathers the rows) in which process 0
        alone writes."""
        payload = self.to_packed_payload()
        if self.mesh is None or self.mesh.rank == 0:
            self.write_packed_npz(path, payload)

    def compact(self) -> "RetrievalEngine":
        """Fold the tail into the main index and drop tombstoned rows: an
        explicit O(corpus) operation (the stored rows come to the host and
        are rebuilt through the usual build path). Doc ids are kept,
        positional ids of an index built without docids included. If the
        rebuild fails, the engine is left exactly as it was."""
        if self.index is None:
            raise RuntimeError("compact() needs a built index")
        if not self._tail_ids and not self._tombstones:
            return self
        P, pm, sc, ids = self._materialize_rows()
        books = (self._true_books().cpu().numpy() if self.dtype == "pq"
                 else None)
        expanded = self.index.books_expanded
        summary_k = self.prune_centroids
        names = ("index", "summary", "tail", "_tail_P", "_tail_pm",
                 "_tail_parts", "_tail_dirty", "_tail_ids", "_tombstones",
                 "_next_auto_id", "_docid_lut_cache", "_alive")
        snapshot = {n: getattr(self, n) for n in names}
        self._reset_incremental()
        try:
            self._compact_build(P, pm, sc, ids, books, expanded, summary_k)
        except BaseException:
            for n, v in snapshot.items():
                setattr(self, n, v)
            raise
        return self

    def _compact_build(self, P, pm, sc, ids, books, expanded,
                       summary_k) -> None:
        if self.dtype == "pq":
            self.build_from_pq(P, books, pm, docids=ids, expanded=expanded)
        elif self.dtype == "int8":
            self.build_from_codes(P, sc, pm, docids=ids)
        elif self.dtype == "int4":
            self.build_from_codes4(P, sc, pm, docids=ids)
        else:
            self.index = self._build_index(_floats(P), pm, docids=ids,
                                           dtype=self.dtype)
        if summary_k > 0:
            # summaries of the stored rows (the dequantized or decoded
            # reconstructions for quantized tiers: what stage 2 scores)
            from evdr_tpu_torch.ops.pruned import (
                build_summary_tokens, build_summary_tokens_from_pq)

            if self.dtype == "pq":
                S, smask = build_summary_tokens_from_pq(
                    P, books, pm, summary_k, expanded=expanded,
                    device=self.device)
            else:
                if self.dtype == "int8":
                    from evdr_tpu_torch.ops.quantize import dequantize_int8

                    Pf = dequantize_int8(P, sc)
                elif self.dtype == "int4":
                    from evdr_tpu_torch.ops.int4 import dequantize_int4

                    Pf = dequantize_int4(P, sc)
                else:
                    Pf = _floats(P)
                S, smask = build_summary_tokens(Pf, pm, summary_k,
                                                device=self.device)
            self._build_summary(S, smask)

    def _merge_tail(self, Qd, qmd, vals, idx, k: int):
        """Merge a main-index top-k (host arrays) with the tail's exact
        top-k and drop tombstones: the (nq, <= k) merged top-k."""
        n_main = self.index.n_docs
        parts_v, parts_i = [vals], [idx]
        if self.tail is not None:
            kt = min(_ceil32(k + len(self._tombstones)), self.tail.n_docs)
            tv, ti = _fetch(*sharded_topk(Qd, qmd, self.tail, k=kt,
                                          impl=self.impl))
            parts_v.append(tv)
            parts_i.append(ti + n_main)
        v = np.concatenate(parts_v, axis=1)
        gi = np.concatenate(parts_i, axis=1)
        if self._tombstones:
            dead = np.isin(gi, np.fromiter(self._tombstones, dtype=np.int64))
            v = np.where(dead, -np.inf, v)
        order = np.argsort(-v, axis=1, kind="stable")
        take = order[:, :min(k, self.n_docs)]
        return (np.take_along_axis(v, take, axis=1),
                np.take_along_axis(gi, take, axis=1))

    def _search_mesh(self, Q, Qd, qmd, k: int, n_candidates, merging: bool):
        """search_dense on a mesh of several shards: the main index's
        top-k (over-fetched by the tombstones when merging, as on one
        device's pruned path), exact or pruned, then the tail merge."""
        ix = self.index
        n_tomb = len(self._tombstones)
        k_main = min(_ceil32(k + n_tomb), ix.n_docs) if merging else k
        if n_candidates:
            # stage 1 selects exactly on the summaries (the reference's
            # approx_max_k is a TPU selection); stage 2 reranks each
            # shard's candidates where they lie
            c = int(n_candidates) + (_ceil32(n_tomb) if n_tomb else 0)
            with span("evdr.engine.queries"):
                Qs = pad_queries(as_tensor(Q, self.device, torch.float32),
                                 self.summary)
            with span("evdr.pruned.stage1"):
                _, cand = _mesh_topk(Qs, qmd, self.summary,
                                     min(c, ix.n_docs), self.impl,
                                     drop_empty=True)
            with span("evdr.pruned.stage2"):
                vals, idx = sharded_rerank(Qd, qmd, ix, cand, k_main)
        else:
            vals, idx = sharded_topk(Qd, qmd, ix, k=k_main, impl=self.impl)
        vals, idx = _fetch(vals, idx)
        if merging:
            return self._merge_tail(Qd, qmd, vals, idx, k)
        if n_candidates:
            return vals, idx
        k_out = min(k, self.n_docs)
        return vals[:, :k_out], idx[:, :k_out]

    @classmethod
    def from_npz(cls, npz_path, mmap: bool = False, **kw
                 ) -> "RetrievalEngine":
        """Accepts the reference's pickled-object interchange npz or the
        packed dense format (tools/convert_packed.py, any storage dtype,
        written by either package). A pq or int4 file serves its codes
        directly on an engine of that dtype (int4 codes only from a
        --normalize file); any other engine builds from the decoded or
        dequantized floats. An interchange npz with ``qat_books`` (a QAT-pq
        student) serves a pq engine with those exact codebooks.

        ``mmap=True`` (packed files): the doc arrays are memory-mapped and
        stream to the device a bounded chunk at a time, so peak anonymous
        host memory stays far below the file's size. It needs a
        ``--normalize`` file (otherwise the host renormalization touches
        everything and the load is an ordinary one); int8 and int4 files
        then serve their codes directly."""
        from evdr_tpu_torch.tools.convert_packed import (is_packed,
                                                         load_packed_payload)

        eng = cls(**kw)
        if is_packed(npz_path):
            payload = load_packed_payload(npz_path, mmap_docs=mmap)
            normalized = bool(payload.get("doc_normalized", False))
            docids = payload.get("docid")
            if "P_pq_codes" in payload:
                if eng.dtype == "pq":
                    expanded = bool(payload.get("P_pq_expanded", False))
                    eng.build_from_pq(
                        payload["P_pq_codes"], payload["P_pq_books"],
                        payload["pmask"], docids=docids, expanded=expanded)
                    if eng.prune_centroids > 0:
                        # the float tokens are gone: summaries of the
                        # decoded reconstructions (what the PQ rerank
                        # scores), decoded chunk by chunk
                        from evdr_tpu_torch.ops.pruned import (
                            build_summary_tokens_from_pq)

                        eng._build_summary(*build_summary_tokens_from_pq(
                            payload["P_pq_codes"], payload["P_pq_books"],
                            payload["pmask"], eng.prune_centroids,
                            expanded=expanded, device=eng.device))
                    return eng
                if "P_pad" not in payload:
                    # a PQ file under mmap for another engine: decode here
                    from evdr_tpu_torch.ops.pq import decode_pq

                    payload["P_pad"] = decode_pq(
                        payload["P_pq_codes"], payload["P_pq_books"],
                        expanded=bool(payload.get("P_pq_expanded", False)))
            # a pruned engine needs the float tokens for its summaries
            codes_ok = normalized and eng.prune_centroids == 0
            if eng.dtype == "int8" and "P_codes" in payload and codes_ok:
                return eng.build_from_codes(
                    payload["P_codes"], payload["P_scale"], payload["pmask"],
                    docids=docids, streaming=mmap)
            if eng.dtype == "int4" and "P_codes4" in payload and codes_ok:
                return eng.build_from_codes4(
                    payload["P_codes4"], payload["P_scale"],
                    payload["pmask"], docids=docids, streaming=mmap)
            if "P_pad" not in payload:
                # int8/int4 codes under mmap that this engine cannot serve
                # as they are: dequantize here
                if "P_codes4" in payload:
                    from evdr_tpu_torch.ops.int4 import dequantize_int4

                    payload["P_pad"] = dequantize_int4(payload["P_codes4"],
                                                       payload["P_scale"])
                else:
                    from evdr_tpu_torch.ops.quantize import dequantize_int8

                    payload["P_pad"] = dequantize_int8(payload["P_codes"],
                                                       payload["P_scale"])
            eng.build(payload["P_pad"], payload["pmask"], docids=docids,
                      # an int4 engine cannot quantize on the stream: a
                      # float or int8 file under it loads eagerly
                      streaming=(mmap and codes_ok and eng.dtype != "int4"),
                      # stored normalized: skip the renorm for THIS build
                      normalize=False if normalized else None)
        else:
            payload = load_payload(npz_path)
            if eng.dtype == "pq" and payload.get("qat_books") is not None:
                # a QAT-pq student: quantize with the exact codebooks it was
                # trained and best-selected against, not a refit
                from evdr_tpu_torch.ops.pq import (books_expanded,
                                                   encode_with_books)

                P, pmask, _ = preprocess_docs(
                    payload["documents"], payload.get("doc_attnmask"),
                    payload.get("doc_imgmask"))
                Pn = np.asarray(l2_normalize(
                    P * pmask[..., None].astype(np.float32)), np.float32)
                books = np.asarray(payload["qat_books"], np.float32)
                eng.pq_m = int(books.shape[0])
                eng.build_from_pq(
                    encode_with_books(Pn, books, pmask), books, pmask,
                    docids=payload.get("docid"),
                    expanded=books.shape[0] > 1
                    and books_expanded(books, Pn.shape[-1]))
            else:
                eng.build_from_ragged(
                    payload["documents"], payload.get("doc_attnmask"),
                    payload.get("doc_imgmask"), docids=payload.get("docid"))
        return eng

    # ----------------------------------------------------------------- search
    def _queries(self, Q, qmask):
        if self.index is None:
            raise RuntimeError("engine has no index; call build() first")
        # queries at the index's true dim meet its padded width here, per
        # call; the index itself was padded once, at build
        with span("evdr.engine.queries"):
            return (pad_queries(as_tensor(Q, self.device, torch.float32),
                                self.index),
                    as_tensor(qmask, self.device, torch.bool))

    def search_dense(self, Q, qmask, k: int = 10,
                     n_candidates: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """(nq, Lq, D) normalized queries + mask -> (scores, doc indices),
        both (nq, min(k, n_docs)) numpy arrays; indices from the main
        index's row count on are tail docs. With ``n_candidates`` (on an
        engine built with ``prune_centroids > 0``): two-stage pruned
        search, (nq, min(k, n_candidates, n_docs)) without incremental
        state."""
        with span("evdr.engine.search"):
            if n_candidates and self.summary is None:
                raise ValueError(
                    "n_candidates requires a pruning summary index: "
                    "construct the engine with prune_centroids>0 and build() "
                    "from float embeddings (build_from_codes has no summary)")
            Qd, qmd = self._queries(Q, qmask)
            self._ensure_tail()  # pending adds materialize on first search
            ix, tail = self.index, self.tail
            merging = tail is not None or bool(self._tombstones)
            if self._sharded:
                return self._search_mesh(Q, Qd, qmd, k, n_candidates, merging)
            if merging and not n_candidates:
                # main + tail + the tombstone mask + top-k on the device
                vals, idx = _single_device_merged_topk(
                    Qd, qmd, ix.P, ix.pmask, None if tail is None else tail.P,
                    None if tail is None else tail.pmask, self._alive_mask(),
                    k, self.impl, ix.n_docs,
                    0 if tail is None else tail.n_docs,
                    scales_m=ix.scales,
                    scales_t=None if tail is None else tail.scales,
                    books=ix.books)
                k_out = min(k, self.n_docs)
                return _fetch(vals[:, :k_out], idx[:, :k_out])
            if n_candidates:
                from evdr_tpu_torch.ops.pruned import pruned_topk_fused

                # over-fetch from the main index so tombstoned rows can be
                # dropped without shrinking the caller's k, and stage-1
                # candidates by the tombstone count (dead docs still take
                # candidate slots), both bucketed to multiples of 32 as in the
                # JAX engine (they change which candidates are reranked)
                n_tomb = len(self._tombstones)
                k_main = min(_ceil32(k + n_tomb), ix.n_docs) if merging else k
                c = int(n_candidates) + (_ceil32(n_tomb) if n_tomb else 0)
                # PQ candidates decode by a gather of book rows: the same f32
                # tokens as the reference's one-hot products (its form for a
                # TPU, which has no gather unit), in one pass
                with span("evdr.engine.queries"):
                    Qs = pad_queries(as_tensor(Q, self.device, torch.float32),
                                     self.summary)
                vals, idx = _fetch(*pruned_topk_fused(
                    Qd, qmd, ix.P, ix.pmask, self.summary.P,
                    self.summary.pmask, k=k_main, n_cand=min(c, ix.n_docs),
                    impl=self.impl, scales=ix.scales,
                    sscales=self.summary.scales,
                    books=ix.books, pq_decode="take", Qs=Qs))
                if merging:
                    return self._merge_tail(Qd, qmd, vals, idx, k)
                return vals, idx
            vals, idx = sharded_topk(Qd, qmd, ix, k=k, impl=self.impl)
            k_out = min(k, self.n_docs)
            return _fetch(vals[:, :k_out], idx[:, :k_out])

    def ids_for(self, idx) -> List[List[str]]:
        """Doc-index matrix -> per-query docid string lists (tail docs
        carry the ids given to add())."""
        n_main = 0 if self.index is None else self.index.n_docs
        ids = None if self.index is None else self.index.docids

        def one(j):
            j = int(j)
            if j >= n_main:
                return str(self._tail_ids[j - n_main])
            return str(ids[j]) if ids is not None else str(j)

        return [[one(j) for j in row] for row in np.asarray(idx)]

    def search(self, queries, query_attnmask=None, k: int = 10,
               n_candidates: Optional[int] = None
               ) -> Tuple[List[List[str]], np.ndarray]:
        """Ragged query token arrays -> (per-query docid lists, scores)."""
        Q, qmask = preprocess_queries(queries, query_attnmask)
        vals, idx = self.search_dense(Q, qmask, k=k,
                                      n_candidates=n_candidates)
        return self.ids_for(idx), vals

    def score_all(self, Q, qmask) -> np.ndarray:
        """Full (nq, N) score matrix (eval / reranking use). With
        incremental state N covers main + tail docs, and tombstoned
        columns are -inf."""
        Qd, qmd = self._queries(Q, qmask)
        self._ensure_tail()
        sc = sharded_maxsim(Qd, qmd, self.index, impl=self.impl)
        if self.tail is not None:
            sc = torch.cat([sc, sharded_maxsim(Qd, qmd, self.tail,
                                               impl=self.impl)], dim=1)
        if self._tombstones:
            sc = sc.masked_fill(~self._alive_mask()[None, :], -torch.inf)
        return sc.cpu().numpy()

    @property
    def n_docs(self) -> int:
        """Searchable (live) documents: main + tail - tombstones, the tail
        counted from its ids, so pending adds already count."""
        if self.index is None:
            return 0
        return (self.index.n_docs + len(self._tail_ids)
                - len(self._tombstones))

    @property
    def dim(self) -> int:
        """Token dim of the built index, before any zero-padding for the
        kernels: ``index.dim``, recorded by ``pad_index_dim`` at every
        build (a PQ index stores codes, so D comes from its books: their
        last dim when expanded, M * D/M when compact)."""
        if self.index is None:
            raise RuntimeError("engine has no index; call build() first")
        return self.index.dim


def _ceil32(n: int) -> int:
    return -(-int(n) // 32) * 32


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x


def _fetch(*ts):
    """A search's results to the host (span ``evdr.engine.fetch``)."""
    with span("evdr.engine.fetch"):
        return tuple(map(_host, ts))


def _pad_tokens(x: np.ndarray, lp: int, fill) -> np.ndarray:
    """Pad axis 1 (tokens) of ``x`` to ``lp`` with ``fill``."""
    if x is None or x.shape[1] == lp:
        return x
    pad = [(0, 0), (0, lp - x.shape[1])] + [(0, 0)] * (x.ndim - 2)
    return np.pad(x, pad, constant_values=fill)


def _fetch_rows(ix: ShardedIndex):
    """Host (tokens or codes, pmask, scales or None) of the valid rows of
    ``ix``, tokens cut back to ``ix.dim`` (PQ codes as stored), bf16
    tokens as their uint16 bits. A mesh's shards are gathered in bounded
    chunks (across processes a collective: ``multihost.gather_to_host``)."""
    n = ix.n_docs

    def tokens(part, rows):
        P = part.P[:rows]
        if part.books is None:
            P = P[..., :ix.dim]
        return P.view(torch.int16) if P.dtype == torch.bfloat16 else P

    bits = ix.first.P.dtype == torch.bfloat16
    if ix.parts is None:
        P = tokens(ix, n).cpu().numpy()
        pm = ix.pmask[:n].cpu().numpy()
        sc = None if ix.scales is None else ix.scales[:n].cpu().numpy()
    else:
        from evdr_tpu_torch.parallel.multihost import gather_to_host

        def rows(ts):
            return gather_to_host(ts, ix.mesh)[:n]

        P = rows([tokens(p, p.shard_rows) for p in ix.parts])
        pm = rows([p.pmask for p in ix.parts])
        sc = (None if ix.first.scales is None
              else rows([p.scales for p in ix.parts]))
    return (P.view(np.uint16) if bits else P, pm, sc)


def _floats(P: np.ndarray) -> np.ndarray:
    """Stored float tokens -> float32 (bf16 bits reinterpreted, exact)."""
    if P.dtype == np.uint16:
        return torch.from_numpy(np.ascontiguousarray(P).view(np.int16)).view(
            torch.bfloat16).float().numpy()
    return np.asarray(P, np.float32)


def _ids(docids):
    return None if docids is None else np.asarray(docids, dtype=object)
