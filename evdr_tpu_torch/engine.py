"""RetrievalEngine — the user-facing multi-vector retrieval API on a GPU.

Loads (or receives) a page-embedding index, places it on one device, and
serves MaxSim top-k queries through the fused CUDA kernels:

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
                                                   pad_index_dim, pad_queries)
from evdr_tpu_torch.parallel.topk import sharded_maxsim, sharded_topk

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
                 device=None):
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
        self.device = resolve_device(device)
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

    def _sdtype(self) -> str:
        """Storage tier of the pruning summary index: ``summary_dtype``,
        else the engine dtype (bfloat16 for PQ: stage 1 has no books)."""
        if self.summary_dtype is not None:
            return self.summary_dtype
        return "bfloat16" if self.dtype == "pq" else self.dtype

    def _build_summary(self, S, smask) -> None:
        self.summary = pad_index_dim(build_sharded_index(
            S, smask, self.device, dtype=self._sdtype()))

    # ------------------------------------------------------------------ build
    def build(self, P, pmask, docids: Optional[Sequence[str]] = None,
              normalize: Optional[bool] = None) -> "RetrievalEngine":
        """Index dense padded page embeddings ``(N, Lp, D)`` + bool mask.

        ``P`` may be a numpy array or a tensor (normalized where it lies).
        ``normalize`` overrides the engine default for THIS build only."""
        normalize = self.normalize if normalize is None else normalize
        if isinstance(P, torch.Tensor):
            pmask = as_tensor(pmask, P.device, torch.bool)
            if normalize:
                P = l2_normalize(P.float() * pmask[..., None])
        else:
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
            self.index = pad_index_dim(build_sharded_index(
                P, pmask, self.device, dtype=self.dtype,
                docids=_ids(docids)))
        if self.prune_centroids > 0:
            from evdr_tpu_torch.ops.pruned import build_summary_tokens

            self._build_summary(*build_summary_tokens(
                P, pmask, self.prune_centroids, device=self.device))
        return self

    def build_from_codes(self, codes, scales, pmask,
                         docids: Optional[Sequence[str]] = None
                         ) -> "RetrievalEngine":
        """Index pre-quantized int8 codes + per-token scales directly (no
        dequantize/renormalize/requantize round trip). Codes must come from
        normalized embeddings (packed files written with --normalize)."""
        if self.dtype != "int8":
            raise ValueError("build_from_codes requires dtype='int8'")
        self.index = pad_index_dim(build_sharded_index(
            codes, pmask, self.device, dtype="int8", scales=scales,
            docids=_ids(docids)))
        return self

    def build_from_codes4(self, packed, scales, pmask,
                          docids: Optional[Sequence[str]] = None
                          ) -> "RetrievalEngine":
        """Index pre-packed int4 codes (N, ceil(Lp/2), D) uint8 + per-token
        scales directly (tools/convert_packed.py --dtype int4 --normalize),
        with no unpack/requantize round trip."""
        if self.dtype != "int4":
            raise ValueError("build_from_codes4 requires dtype='int4'")
        self.index = pad_index_dim(build_sharded_index(
            packed, pmask, self.device, dtype="int4", scales=scales,
            docids=_ids(docids)))
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
        if self.dtype != "pq":
            raise ValueError("build_from_pq requires dtype='pq'")
        self.index = build_sharded_index(
            as_tensor(codes, self.device, torch.uint8), pmask, self.device,
            docids=_ids(docids))
        self.index.books = as_tensor(books, self.device,
                                     torch.float32).contiguous()
        self.index.books_expanded = bool(expanded)
        self.index = pad_index_dim(self.index)
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
        or tensors, used as stored (see ``evdr_tpu_torch.convert``)."""
        from evdr_tpu_torch.convert import index_from_numpy

        eng = cls(**kw)
        eng.index = pad_index_dim(index_from_numpy(
            P, pmask, n_docs, scales=scales, docids=docids, books=books,
            books_expanded=books_expanded, device=eng.device))
        return eng

    @classmethod
    def from_npz(cls, npz_path, mmap: bool = False, **kw
                 ) -> "RetrievalEngine":
        """Accepts the reference's pickled-object interchange npz or the
        packed dense format (tools/convert_packed.py, any storage dtype,
        written by either package). A pq or int4 file serves its codes
        directly on an engine of that dtype (int4 codes only from a
        --normalize file); any other engine builds from the decoded or
        dequantized floats. An interchange npz with ``qat_books`` (a QAT-pq
        student) serves a pq engine with those exact codebooks."""
        if mmap:
            raise NotImplementedError(
                "from_npz(mmap=True) is not ported to evdr_tpu_torch yet "
                "(ROADMAP.md queue 1, 'Incremental serving')")
        from evdr_tpu_torch.tools.convert_packed import (is_packed,
                                                         load_packed_payload)

        eng = cls(**kw)
        if is_packed(npz_path):
            payload = load_packed_payload(npz_path)
            normalized = bool(payload.get("doc_normalized", False))
            docids = payload.get("docid")
            if eng.dtype == "pq" and "P_pq_codes" in payload:
                expanded = bool(payload.get("P_pq_expanded", False))
                eng.build_from_pq(
                    payload["P_pq_codes"], payload["P_pq_books"],
                    payload["pmask"], docids=docids, expanded=expanded)
                if eng.prune_centroids > 0:
                    # the float tokens are gone: summaries of the decoded
                    # reconstructions (what the PQ rerank scores), decoded
                    # chunk by chunk
                    from evdr_tpu_torch.ops.pruned import (
                        build_summary_tokens_from_pq)

                    eng._build_summary(*build_summary_tokens_from_pq(
                        payload["P_pq_codes"], payload["P_pq_books"],
                        payload["pmask"], eng.prune_centroids,
                        expanded=expanded, device=eng.device))
                return eng
            # a pruned engine needs the float tokens for its summaries
            codes_ok = normalized and eng.prune_centroids == 0
            if eng.dtype == "int8" and "P_codes" in payload and codes_ok:
                return eng.build_from_codes(
                    payload["P_codes"], payload["P_scale"], payload["pmask"],
                    docids=docids)
            if eng.dtype == "int4" and "P_codes4" in payload and codes_ok:
                return eng.build_from_codes4(
                    payload["P_codes4"], payload["P_scale"],
                    payload["pmask"], docids=docids)
            eng.build(payload["P_pad"], payload["pmask"], docids=docids,
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
        return (pad_queries(as_tensor(Q, self.device, torch.float32),
                            self.index),
                as_tensor(qmask, self.device, torch.bool))

    def search_dense(self, Q, qmask, k: int = 10,
                     n_candidates: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """(nq, Lq, D) normalized queries + mask -> (scores, doc indices),
        both (nq, min(k, n_docs)) numpy arrays. With ``n_candidates`` (on
        an engine built with ``prune_centroids > 0``): two-stage pruned
        search, (nq, min(k, n_candidates, n_docs))."""
        if n_candidates and self.summary is None:
            raise ValueError(
                "n_candidates requires a pruning summary index: construct "
                "the engine with prune_centroids>0 and build() from float "
                "embeddings (build_from_codes has no summary)")
        Qd, qmd = self._queries(Q, qmask)
        if n_candidates:
            from evdr_tpu_torch.ops.pruned import pruned_topk_fused

            # PQ candidates decode by a gather of book rows: the same f32
            # tokens as the reference's one-hot products (its form for a
            # TPU, which has no gather unit), in one pass
            Q_true = as_tensor(Q, self.device, torch.float32)
            vals, idx = pruned_topk_fused(
                Qd, qmd, self.index.P, self.index.pmask, self.summary.P,
                self.summary.pmask, k=k,
                n_cand=min(int(n_candidates), self.n_docs), impl=self.impl,
                scales=self.index.scales, sscales=self.summary.scales,
                books=self.index.books, pq_decode="take",
                Qs=pad_queries(Q_true, self.summary))
            return vals.cpu().numpy(), idx.cpu().numpy()
        vals, idx = sharded_topk(Qd, qmd, self.index, k=k, impl=self.impl)
        k_out = min(k, self.n_docs)
        return vals[:, :k_out].cpu().numpy(), idx[:, :k_out].cpu().numpy()

    def ids_for(self, idx) -> List[List[str]]:
        """Doc-index matrix -> per-query docid string lists."""
        ids = None if self.index is None else self.index.docids
        return [[str(ids[int(j)]) if ids is not None else str(int(j))
                 for j in row] for row in np.asarray(idx)]

    def search(self, queries, query_attnmask=None, k: int = 10,
               n_candidates: Optional[int] = None
               ) -> Tuple[List[List[str]], np.ndarray]:
        """Ragged query token arrays -> (per-query docid lists, scores)."""
        Q, qmask = preprocess_queries(queries, query_attnmask)
        vals, idx = self.search_dense(Q, qmask, k=k,
                                      n_candidates=n_candidates)
        return self.ids_for(idx), vals

    def score_all(self, Q, qmask) -> np.ndarray:
        """Full (nq, N) score matrix (eval / reranking use)."""
        Qd, qmd = self._queries(Q, qmask)
        return sharded_maxsim(Qd, qmd, self.index, impl=self.impl
                              ).cpu().numpy()

    @property
    def n_docs(self) -> int:
        return 0 if self.index is None else self.index.n_docs

    @property
    def dim(self) -> int:
        """Token dim of the built index, before any zero-padding for the
        kernels: ``index.dim``, recorded by ``pad_index_dim`` at every
        build (a PQ index stores codes, so D comes from its books: their
        last dim when expanded, M * D/M when compact)."""
        if self.index is None:
            raise RuntimeError("engine has no index; call build() first")
        return self.index.dim


def _ids(docids):
    return None if docids is None else np.asarray(docids, dtype=object)
