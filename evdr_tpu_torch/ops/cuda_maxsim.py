"""Fused masked MaxSim on the GPU: wrappers of the hand-written Hopper
kernels (``csrc/maxsim_bf16.cu``, ``csrc/maxsim_f32.cu``,
``csrc/maxsim_int8.cu``, ``csrc/maxsim_int8_defer.cu``,
``csrc/maxsim_int4.cu``, ``csrc/maxsim_pq.cu``)
and, beside each, its plain PyTorch version.

Counterpart of ``evdr_tpu/ops/pallas_maxsim.py``'s forward kernels:

- ``maxsim_cuda`` (K1): float/bf16 index, scored in bf16 with f32
  accumulation (a float32 index is cast to bf16 per call, as the TPU
  kernel's host side does) by a kernel on wgmma and TMA (its configuration
  by D: :func:`bf16_config`); ``compute_dtype=torch.float32`` hands the
  call to ``maxsim_cuda_f32``.
- ``maxsim_cuda_f32`` (K1, float32 mode, the TPU kernel's
  ``compute_dtype=float32``): split-TF32 products with f32 accumulation,
  the scorer of the trainer's evaluation and teacher precompute; a kernel
  of its own (64 x 32 outputs a warp, its tile configuration chosen by D,
  :func:`f32_occupancy`).
- ``maxsim_cuda_int8`` (K2, int8 mode): bf16 queries x int8 codes.
- ``maxsim_cuda_int8full`` (K2, int8full mode): queries quantized per token
  on the device (``quantize_queries_int8``), int8 x int8 -> int32; pages of
  at least ``WG_MIN_LP`` tokens go to a kernel of their own on wgmma and
  TMA (``csrc/maxsim_int8full_wg.cu``, :func:`int8full_func`), bit-equal
  to the mma.sync loop that shorter pages keep.
- ``maxsim_cuda_int8_deferred`` / ``maxsim_cuda_int8full_deferred`` (K2b,
  reached as ``deferred=True`` of the two K2 wrappers, the JAX keyword):
  K2's scores bit for bit, with each doc's epilogue run one page tile late;
  their plain versions are K2's.
- ``maxsim_cuda_int4`` / ``maxsim_cuda_int4full`` (K4): the same two modes
  over token-pair packed int4 codes (``ops/int4.py``).
- ``maxsim_cuda_pq`` / ``maxsim_cuda_pqfull`` (K3): PQ codes decoded into
  tokens from int8-quantized codebooks, then the bf16 or int8 x int8 loop;
  thread-block clusters of :func:`pq_cluster` CTAs share each page tile's
  decode.

Shapes: a launch takes at most ``row_cap(library, D)`` query tokens (its
CTA's query-token rows) and D a multiple of ``D_GRANULE``. A wrapper scores
a longer query in slices of at most that many tokens and adds their
partial scores (``split_queries``; a tolerance against one pass, since
only the order of f32 additions changes), and zero-pads a narrower D
(exact). Every D is served: up to ``MAX_D`` (float32 modes: ``F32_MAX_D``)
by the fast kernels, which hold the operand tiles whole in shared memory,
and above it by each library's wide function (``<func>_wide``,
``csrc/maxsim_wide.cuh``), which sums each page tile's similarities over D
in chunks before the max (a max over tokens does not split over D, a sum
over D does). The engine pads its stored index once, at build
(``parallel/sharded_index.pad_index_dim``), so the per-call pad touches
only the queries.

Routing: a wrapper given CUDA tensors launches its kernel or raises; given
CPU tensors it returns its plain version. There is no other fallback.
Each wrapper counts its launches in a plain integer attribute
(``maxsim_cuda.launches`` ...), raised by one exactly where it launches,
and by kernel function and shape in ``launch_shapes``, whose function name
tells a wide launch from a fast one (``func_launches``). ``INDEX_BYTES_READ``
counts, by library, the bytes of the index operands (codes or tokens,
scales, mask) each launch covers: a query longer than a launch's rows
reads the index once a slice.

The plain versions reproduce the kernels' numerics: bf16 casts of the
inputs, f32 sums, the -1e30 fill of an invalid doc token, the rule that a
doc whose max stayed below -1e29 (no valid token) scores 0, the -1 scale
sentinel (a valid token with scale 0 scores 0 and is not masked) and the
same query quantization. They differ from the kernels only in summation
order. On a GPU they need full-precision f32 matmuls (no TF32).
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from evdr_tpu_torch.ops import _cuda_build

NEG_INIT = -1e30   # an invalid doc token's similarity
NEG_THRESH = -1e29  # a running max below this: the doc had no valid token

# rows x columns of the similarity block one plain chunk materializes
_PLAIN_CHUNK_ELEMS = 1 << 27

KERNEL_ROWS = 128   # query-token rows per CTA (maxsim_tile.cuh kRows)
# The most query tokens one launch of each library takes: its CTA's
# query-token rows (K1 and K5 bf16 run two warpgroups of 128 rows,
# maxsim_bf16.cu; K2, K2b and K4 stand on 256-row tiles, maxsim_tile.cuh
# CfgWide; K6 on 128, maxsim_train.cu). A longer query is scored in slices
# of at most this many tokens whose partial scores add up (split_queries).
# K1 and K5 float32 (maxsim_f32.cu) take their tile's rows, which depend on
# D: ``row_cap``.
ROW_CAP = {"maxsim_bf16": 2 * KERNEL_ROWS, "maxsim_int8": 2 * KERNEL_ROWS,
           "maxsim_int4": 2 * KERNEL_ROWS,
           "maxsim_int8_defer": 2 * KERNEL_ROWS, "maxsim_pq": KERNEL_ROWS,
           "maxsim_train": KERNEL_ROWS}
# maxsim_f32.cu's rule by D: 256 x 64 tiles up to this kernel width (where
# they fit in shared memory), 128 x 32 above
F32_TALL_MAX_D = 144


# The wide functions (maxsim_wide.cuh) stand on CfgWide's 256-row tiles in
# every library; the wide K6 takes any number of query tokens at once.
WIDE_ROWS = 2 * KERNEL_ROWS
# The kernels take D a multiple of D_GRANULE; a narrower D is zero-padded
# up to it, which adds nothing to any product. The fast kernels hold their
# operand tiles whole in shared memory up to MAX_D (float32 modes:
# F32_MAX_D); a wider D goes to the library's wide function.
D_GRANULE = 16
MAX_D = 256
# K1/K5/K6 float32: the f32 query block and two page tiles in shared memory
F32_MAX_D = 192
# K2 int8full's wgmma kernel takes pages of at least this many tokens (at
# 64, half of each of its 128-token tiles, it still beat the mma.sync loop
# on the card, PERF.md section 6); shorter pages (pruned stage 1 scores 4
# centroids a page) keep the mma.sync loop
WG_MIN_LP = 64


def is_wide(func: str, d: int) -> bool:
    """Whether kernel function ``func`` (its fast name) runs kernel width
    ``d`` on its wide function: above F32_MAX_D for the float32 modes
    (``*f32*``), above MAX_D for the others."""
    return d > (F32_MAX_D if "f32" in func else MAX_D)


def kernel_func(func: str, d: int) -> str:
    """The function a launch of ``func`` at kernel width ``d`` calls:
    ``func`` itself, or ``func + '_wide'`` above its fast bound."""
    return func + "_wide" if is_wide(func, d) else func


def int8full_func(lp: int, d: int) -> str:
    """The function K2 int8full launches over pages of ``lp`` tokens at
    kernel width ``d``: the wgmma kernel from ``WG_MIN_LP`` tokens up to
    ``MAX_D``, else the mma.sync loop (``kernel_func`` then takes it to its
    wide function above ``MAX_D``)."""
    if lp >= WG_MIN_LP and not is_wide("evdr_maxsim_int8full", d):
        return "evdr_maxsim_int8full_wg"
    return "evdr_maxsim_int8full"


def row_cap(lib: str, d: int) -> int:
    """The most query tokens one launch of library ``lib`` takes at kernel
    width ``d`` (K6, ``maxsim_train``: its fast kernel's; the wide K6 takes
    any number)."""
    if lib == "maxsim_train":
        return ROW_CAP[lib]
    if d > (F32_MAX_D if lib == "maxsim_f32" else MAX_D):
        return WIDE_ROWS
    if lib == "maxsim_f32":
        return 2 * KERNEL_ROWS if d <= F32_TALL_MAX_D else KERNEL_ROWS
    return ROW_CAP[lib]


# K3's largest cluster: 8 (the portable size) where the decode sums
# full-width book rows from L2, 2 where it concatenates compact rows from
# shared memory (measured, PERF.md)
MAX_CLUSTER = {"compact": 2, "full": 8}

# (wrapper name, kernel function, nq, Lq, nd, Lp) -> launches
launch_shapes: Counter = Counter()
# library -> bytes of index operands its launches covered (_count_index)
INDEX_BYTES_READ = {"maxsim_bf16": 0, "maxsim_f32": 0, "maxsim_int8": 0,
                    "maxsim_int8_defer": 0, "maxsim_int4": 0,
                    "maxsim_pq": 0}


def quantize_queries_int8(Q: torch.Tensor, qmask: torch.Tensor):
    """Per-query-token symmetric int8 quantization, as
    ``maxsim_pallas_int8full`` does on the TPU: s = amax/127, codes =
    round-half-even(Q / s) clipped to +-127. Returns (codes int8, the
    post-max weight qmask * s as f32)."""
    Qf = Q.float()
    # divide by a tensor: CUDA divides by a Python scalar as a product
    # with its reciprocal, up to 1 ulp off the host quantizer's scales
    amax = Qf.abs().amax(dim=-1)
    sq = amax / torch.full_like(amax, 127.0)
    safe = torch.where(sq > 0, sq, torch.ones_like(sq))
    codes = torch.round(Qf / safe[..., None]).clamp_(-127, 127).to(torch.int8)
    return codes, qmask.float() * sq


# ----------------------------------------------------------------- plain


def plain_sims(Qf, P, p_dtype, tok_scale):
    """Yield ``(i, Pc, sim)`` over doc chunks: Pc = ``P[i:i+c]`` seen as
    ``.to(p_dtype).float()`` (or, where ``p_dtype`` is a function, as
    ``p_dtype(P[i:i+c])``: the (c, Lp, D) f32 tokens of stored codes); sim
    (nq * Lq, c, Lp) f32, the masked, scaled similarities (-1e30 at an
    invalid token). Qf (nq, Lq, D) f32 holds the values the kernel
    multiplies; tok_scale (nd, Lp): a scale >= 0 multiplies the similarity,
    -1 marks an invalid token. The chunking depends only on the shapes, so
    two calls on the same inputs give bit-identical similarities (the
    plain K5/K6 pair relies on it)."""
    if Qf.is_cuda and torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("the plain MaxSim versions need full-precision "
                           "f32 matmuls; set torch.set_float32_matmul_"
                           "precision('highest')")
    nq, lq, d = Qf.shape
    nd, lp = tok_scale.shape
    decode = p_dtype if callable(p_dtype) else (
        lambda x: x.to(p_dtype).float())
    rows = Qf.reshape(nq * lq, d)
    chunk = max(1, _PLAIN_CHUNK_ELEMS // (nq * lq * lp))
    for i in range(0, nd, chunk):
        Pc = decode(P[i:i + chunk])
        c = Pc.shape[0]
        sim = (rows @ Pc.reshape(c * lp, d).T).view(nq * lq, c, lp)
        sc = tok_scale[i:i + chunk]
        yield i, Pc, torch.where(sc >= 0, sim * sc, NEG_INIT)


def _plain_core(Qf, qw, P, p_dtype, tok_scale, want_m=False):
    """Chunked masked MaxSim -> (nq, nd) f32 (see :func:`plain_sims`);
    qw (nq, Lq) post-max weights. ``want_m`` also returns M (nq * Lq, nd),
    each row's raw max before the no-valid-token rule (K5's residual)."""
    nq, lq, _ = Qf.shape
    nd = P.shape[0]
    out = torch.empty((nq, nd), dtype=torch.float32, device=Qf.device)
    M = (torch.empty((nq * lq, nd), dtype=torch.float32, device=Qf.device)
         if want_m else None)
    for i, Pc, sim in plain_sims(Qf, P, p_dtype, tok_scale):
        c = Pc.shape[0]
        mx = sim.amax(dim=-1)
        if want_m:
            M[:, i:i + c] = mx
        mx = torch.where(mx > NEG_THRESH, mx, 0.0)
        out[:, i:i + c] = (mx.view(nq, lq, c) * qw[..., None]).sum(dim=1)
    return (out, M) if want_m else out


def mask_sentinel(pmask, scales=None):
    valid = pmask.bool()
    s = torch.ones_like(valid, dtype=torch.float32) if scales is None \
        else scales.float()
    return torch.where(valid, s, -1.0)


def maxsim_plain(Q, P, qmask, pmask, compute=torch.bfloat16):
    """Plain version of K1: (nq, nd) f32. ``compute=torch.float32`` scores
    at full precision (the TPU kernel's ``compute_dtype=float32``)."""
    return _plain_core(Q.to(compute).float(), qmask.float(), P, compute,
                       mask_sentinel(pmask))


def maxsim_int8_plain(Q, P_i8, scales, qmask, pmask,
                      compute=torch.bfloat16):
    """Plain version of K2 in int8 mode: queries in ``compute``, codes
    exact, page scale applied before the max."""
    return _plain_core(Q.to(compute).float(), qmask.float(), P_i8,
                       torch.float32, mask_sentinel(pmask, scales))


def maxsim_int8full_plain(Q, P_i8, scales, qmask, pmask):
    """Plain version of K2 in int8full mode. The int8 x int8 dot products
    are exact in f32 (|sum| <= 127 * 127 * D < 2**24 for D <= 1040)."""
    Q_i8, qw = quantize_queries_int8(Q, qmask)
    return _plain_core(Q_i8.float(), qw, P_i8, torch.float32,
                       mask_sentinel(pmask, scales))


def unpack_int4_torch(packed: torch.Tensor, lp: int) -> torch.Tensor:
    """(..., ceil(Lp/2), D) token-pair packed uint8 -> (..., Lp, D) int8
    codes in token order: the low nibble is token 2t, the high nibble token
    2t+1, each sign-extended from 4 bits (``ops/int4.py``)."""
    b = packed.to(torch.int16)
    lo = ((b & 0xF) ^ 8) - 8
    hi = ((b >> 4) ^ 8) - 8
    out = torch.stack([lo, hi], dim=-2).reshape(
        *packed.shape[:-2], 2 * packed.shape[-2], packed.shape[-1])
    return out[..., :lp, :].to(torch.int8)


def maxsim_int4_plain(Q, P_u8, scales, qmask, pmask,
                      compute=torch.bfloat16):
    """Plain version of K4 in int4 mode: queries in ``compute``, codes
    exact, page scale applied before the max."""
    lp = pmask.shape[1]
    return _plain_core(Q.to(compute).float(), qmask.float(), P_u8,
                       lambda x: unpack_int4_torch(x, lp).float(),
                       mask_sentinel(pmask, scales))


def maxsim_int4full_plain(Q, P_u8, scales, qmask, pmask):
    """Plain version of K4 in int4full mode: int8 queries x int4 codes,
    exact dot products, as K2's int8full."""
    lp = pmask.shape[1]
    Q_i8, qw = quantize_queries_int8(Q, qmask)
    return _plain_core(Q_i8.float(), qw, P_u8,
                       lambda x: unpack_int4_torch(x, lp).float(),
                       mask_sentinel(pmask, scales))


PQ_KMAX = 256  # uint8 codes: at most 256 centroids per subspace


def quantize_books_int8(books: torch.Tensor):
    """Symmetric int8 quantization of codebooks with ONE global scale, as
    the TPU kernel's host side does (``pallas_maxsim.quantize_books_int8``):
    (M, K, w) float -> ((M, K, w) int8, 0-d f32 scale). A single scale keeps
    a decoded token a plain int32 sum of book rows; it is folded into the
    post-max query weight."""
    books = books.float()
    amax = books.abs().amax()
    s = amax / torch.full_like(amax, 127.0)
    safe = torch.where(s > 0, s, torch.ones_like(s))
    return (torch.round(books / safe).clamp_(-127, 127).to(torch.int8),
            safe)


def pq_books(books, d: int, device):
    """Host side of K3 (``_maxsim_pq_impl``): -> (compact, int8 books,
    scale). ``compact`` is False for expanded (M, K, D) OPQ books, whose
    rows SUM; compact (M, K, D/M) books concatenate. Quantizing the compact
    books gives the same codes and scale as quantizing their block-diagonal
    embedding (``_embed_books_full``): the embedding adds only zeros."""
    books = torch.as_tensor(books, device=device)
    m, k, w = books.shape
    compact = not (m > 1 and w == d)
    if compact and m * w != d:
        raise ValueError(f"books {tuple(books.shape)} do not match token "
                         f"dim {d}")
    if k > PQ_KMAX:
        raise ValueError(f"uint8 codes support K <= {PQ_KMAX} centroids; "
                         f"got K={k}")
    books_q, scale = quantize_books_int8(books)
    return compact, books_q, scale


def pq_full_books(books_q, compact: bool, d: int) -> torch.Tensor:
    """int8 books -> (M, 256, D) int32 rows whose sum over m decodes a
    token: a compact book embedded block-diagonally (its row fills dims
    [m*w, (m+1)*w)), zero rows past K (the codes a one-hot decode against
    zero-padded books maps to nothing)."""
    m, k, w = books_q.shape
    full = torch.zeros((m, PQ_KMAX, d), dtype=torch.int32,
                       device=books_q.device)
    if compact:
        for j in range(m):
            full[j, :k, j * w:(j + 1) * w] = books_q[j].to(torch.int32)
    else:
        full[:, :k] = books_q.to(torch.int32)
    return full


def pq_decode_int(codes, full) -> torch.Tensor:
    """(..., M) uint8 codes -> (..., D) int32 decoded tokens: the exact sum
    of the M book rows of :func:`pq_full_books`."""
    idx = codes.long()
    out = full[0][idx[..., 0]]
    for j in range(1, full.shape[0]):
        out += full[j][idx[..., j]]
    return out


def _pq_plain(Qf, qw, codes, pmask, books, compute, int8_queries):
    d = Qf.shape[-1]
    compact, books_q, s = pq_books(books, d, codes.device)
    full = pq_full_books(books_q, compact, d)
    # the decoded tile: exact int8 for the int8 x int8 loop (int8 queries,
    # compact books), else the int32 sum cast to the compute dtype (bf16
    # rounds sums above 256, as the kernels do)
    tile = torch.float32 if (int8_queries and compact) else compute
    return _plain_core(Qf, qw * s, codes,
                       lambda c: pq_decode_int(c, full).to(tile).float(),
                       mask_sentinel(pmask))


def maxsim_pq_plain(Q, codes, qmask, pmask, books, compute=torch.bfloat16):
    """Plain version of K3 in pq mode: queries in ``compute`` x tokens
    decoded from int8-quantized books and cast to ``compute``; the book
    scale rides in the post-max query weight."""
    return _pq_plain(Q.to(compute).float(), qmask.float(), codes, pmask,
                     books, compute, int8_queries=False)


def maxsim_pqfull_plain(Q, codes, qmask, pmask, books,
                        compute=torch.bfloat16):
    """Plain version of K3 in pqfull mode: queries quantized per token to
    int8. Compact books decode to an exact int8 tile and score int8 x int8;
    expanded OPQ books (sums may leave int8) score the int8 queries cast
    up, against the tile in ``compute``, as ``pallas_maxsim.py:1276``
    gates it."""
    Q_i8, qw = quantize_queries_int8(Q, qmask)
    return _pq_plain(Q_i8.float(), qw, codes, pmask, books, compute,
                     int8_queries=True)


# --------------------------------------------------------------- kernels


def _on_cuda(*tensors) -> bool:
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(f"MaxSim inputs must share one device, got "
                     f"{sorted(str(t.device) for t in tensors)}")


def _check_shapes(Q, P, qmask, pmask, scales=None, p_shape=None):
    """``p_shape``: the (nd, Lp, D) of the tokens ``P`` stores, where they
    are codes of another layout (packed int4, PQ); default ``P.shape``."""
    if Q.dim() != 3 or P.dim() != 3:
        raise ValueError(f"Q and P must be 3-D, got {tuple(Q.shape)} and "
                         f"{tuple(P.shape)}")
    nq, lq, d = Q.shape
    nd, lp, dp = P.shape if p_shape is None else p_shape
    if dp != d:
        raise ValueError(f"query dim {d} != page dim {dp}")
    if tuple(qmask.shape) != (nq, lq) or tuple(pmask.shape) != (nd, lp):
        raise ValueError("mask shapes do not match Q / P")
    if scales is not None and tuple(scales.shape) != (nd, lp):
        raise ValueError(f"scales shape {tuple(scales.shape)} != {(nd, lp)}")
    if pmask.dtype != torch.bool:
        raise TypeError(f"pmask must be bool, got {pmask.dtype}")
    kernel_dim(d)
    for name, t in (("P", P), ("pmask", pmask), ("scales", scales)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if nq == 0 or nd == 0 or lp == 0:
        raise ValueError("empty MaxSim input")


def kernel_dim(d: int, granule: int = D_GRANULE) -> int:
    """The width a kernel runs token dim ``d`` at: ``d`` rounded up to
    ``granule`` (the pad lanes are zero)."""
    if d < 1:
        raise ValueError(f"MaxSim tokens need D >= 1, got {d}")
    return -(-d // granule) * granule


def pad_dim(x: torch.Tensor, d_to: int) -> torch.Tensor:
    """Zero-pad the last axis of ``x`` to ``d_to``; ``x`` itself where it is
    that wide already."""
    d = x.shape[-1]
    return x if d == d_to else torch.nn.functional.pad(x, (0, d_to - d))


def split_queries(score, Q, qw, cap: int):
    """``score(Q, qw)`` for queries of any length: with Lq above ``cap``
    (a kernel's query-token rows per CTA), the sum of ``score`` over
    slices of at most ``cap`` tokens, first to last. MaxSim sums over query
    tokens, so the slices' partial scores add up to the whole; only the
    order of the f32 additions differs from one pass (a tolerance, not
    bit-equality). Within the cap, ``score`` runs once on the inputs as
    given. ``Q`` (nq, Lq, ...) and ``qw`` (nq, Lq) are sliced on axis 1."""
    lq = Q.shape[1]
    if lq <= cap:
        return score(Q, qw)
    out = None
    for s in range(0, lq, cap):
        part = score(Q[:, s:s + cap], qw[:, s:s + cap])
        out = part if out is None else out + part
    return out


def call_kernel(lib, func, operands, *args, aligned=()):
    """Launch ``func`` of library ``lib`` on the current stream of the
    operands' device: ``operands`` are tensors passed as pointers (None
    entries are skipped), then the ints ``args``. The tensors in
    ``aligned`` (those the kernel reads 16 bytes at a time) must be 16-byte
    aligned. Raises if the launch is refused."""
    for t in aligned:
        if t.data_ptr() % 16:
            raise ValueError("kernel operands must be 16-byte aligned")
    fn = _cuda_build.kernel(lib, func)
    dev = operands[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(t.data_ptr() for t in operands if t is not None), *args,
                stream)
    if rc != 0:
        raise RuntimeError(f"{func} launch failed: " + (
            f"cudaError {rc}" if rc > 0
            else f"tensor-map encode refused, CUresult {-rc}"))


def _launch(wrapper, lib, func, q, qw, P, scales, pmask):
    """Launch ``func`` of ``lib`` on (nq, Lq, D) queries ``q`` in the
    kernel's type with post-max weights ``qw`` against ``P`` (whose last
    axis is D, zero-padded up to the kernel's granule here where it is
    not), once per slice of at most ``row_cap(lib, D)`` query tokens, on
    its wide function above the fast bound; each launch counts on
    ``wrapper``."""
    nq, _, d = q.shape
    nd, lp = pmask.shape
    dk = kernel_dim(d)
    q, P = pad_dim(q, dk), pad_dim(P, dk)
    func = kernel_func(func, dk)

    def one(qs, qws):
        qs, qws = qs.contiguous(), qws.contiguous()
        out = torch.empty((nq, nd), dtype=torch.float32, device=q.device)
        call_kernel(lib, func, (qs, qws, P, scales, pmask, out), nq,
                    qs.shape[1], nd, lp, dk, aligned=(qs, P))
        _count(wrapper, func, nq, qs.shape[1], nd, lp)
        _count_index(lib, P, scales, pmask)
        return out

    return split_queries(one, q, qw, row_cap(lib, dk))


def maxsim_cuda(Q, P, qmask, pmask, compute_dtype=torch.bfloat16):
    """K1: fused MaxSim of (nq, Lq, D) queries against a bf16 (or float32,
    cast per call) (nd, Lp, D) index -> (nq, nd) f32. ``compute_dtype``
    torch.float32 scores at float32 precision (``maxsim_cuda_f32``)."""
    if compute_dtype == torch.float32:
        return maxsim_cuda_f32(Q, P, qmask, pmask)
    if compute_dtype != torch.bfloat16:
        raise TypeError(f"K1 computes in bfloat16 or float32, got "
                        f"{compute_dtype}")
    if not _on_cuda(Q, P, qmask, pmask):
        return maxsim_plain(Q, P, qmask, pmask)
    _check_shapes(Q, P, qmask, pmask)
    if P.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"K1 takes a bf16 or f32 index, got {P.dtype}")
    return _launch(maxsim_cuda, "maxsim_bf16", "evdr_maxsim_bf16",
                   Q.to(torch.bfloat16), qmask.float(),
                   P.to(torch.bfloat16), None, pmask)


def maxsim_cuda_f32(Q, P, qmask, pmask):
    """K1 in float32 mode (split-TF32 products, f32 sums): (nq, Lq, D)
    queries against a float32 or bf16 (upcast exactly) (nd, Lp, D) index
    -> (nq, nd) f32."""
    if not _on_cuda(Q, P, qmask, pmask):
        return maxsim_plain(Q, P, qmask, pmask, compute=torch.float32)
    _check_shapes(Q, P, qmask, pmask)
    if P.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"K1 takes a bf16 or f32 index, got {P.dtype}")
    return _launch(maxsim_cuda_f32, "maxsim_f32", "evdr_maxsim_f32",
                   Q.float(), qmask.float(), P.float().contiguous(), None,
                   pmask)


def _check_int8(P_i8, scales):
    if P_i8.dtype != torch.int8:
        raise TypeError(f"K2 takes int8 codes, got {P_i8.dtype}")
    if scales.dtype != torch.float32:
        raise TypeError(f"K2 takes f32 scales, got {scales.dtype}")


def _launch_int8(wrapper, lib, func, Q, P_i8, scales, qmask, pmask,
                 int8_queries):
    """K2's and K2b's host side: checks, the queries in the kernel's type
    (bf16, or int8 quantized per token with their scale folded into the
    post-max weight), the launches."""
    _check_shapes(Q, P_i8, qmask, pmask, scales)
    _check_int8(P_i8, scales)
    if int8_queries:
        Qk, qw = quantize_queries_int8(Q, qmask)
    else:
        Qk, qw = Q.to(torch.bfloat16), qmask.float()
    return _launch(wrapper, lib, func, Qk, qw, P_i8, scales, pmask)


def maxsim_cuda_int8(Q, P_i8, scales, qmask, pmask, deferred=False):
    """K2, int8 mode: bf16 queries x int8 codes with per-token scales.
    ``deferred=True``: K2b (:func:`maxsim_cuda_int8_deferred`), the same
    scores."""
    if deferred:
        return maxsim_cuda_int8_deferred(Q, P_i8, scales, qmask, pmask)
    if not _on_cuda(Q, P_i8, scales, qmask, pmask):
        return maxsim_int8_plain(Q, P_i8, scales, qmask, pmask)
    return _launch_int8(maxsim_cuda_int8, "maxsim_int8", "evdr_maxsim_int8",
                        Q, P_i8, scales, qmask, pmask, int8_queries=False)


def maxsim_cuda_int8full(Q, P_i8, scales, qmask, pmask, deferred=False):
    """K2, int8full mode: queries quantized per token on the device, then
    int8 x int8 -> int32 on the tensor cores. ``deferred=True``: K2b
    (:func:`maxsim_cuda_int8full_deferred`), the same scores."""
    if deferred:
        return maxsim_cuda_int8full_deferred(Q, P_i8, scales, qmask, pmask)
    if not _on_cuda(Q, P_i8, scales, qmask, pmask):
        return maxsim_int8full_plain(Q, P_i8, scales, qmask, pmask)
    return _launch_int8(maxsim_cuda_int8full, "maxsim_int8",
                        int8full_func(pmask.shape[-1],
                                      kernel_dim(Q.shape[-1])),
                        Q, P_i8, scales, qmask, pmask, int8_queries=True)


def maxsim_cuda_int8_deferred(Q, P_i8, scales, qmask, pmask):
    """K2b, int8 mode (``pallas_maxsim.py:_kernel_int8_defer``): K2's int8
    mode with each doc's epilogue deferred one page tile; bit-equal to
    :func:`maxsim_cuda_int8`, so its plain version is K2's."""
    if not _on_cuda(Q, P_i8, scales, qmask, pmask):
        return maxsim_int8_plain(Q, P_i8, scales, qmask, pmask)
    return _launch_int8(maxsim_cuda_int8_deferred, "maxsim_int8_defer",
                        "evdr_maxsim_int8_defer", Q, P_i8, scales, qmask,
                        pmask, int8_queries=False)


def maxsim_cuda_int8full_deferred(Q, P_i8, scales, qmask, pmask):
    """K2b, int8full mode: bit-equal to :func:`maxsim_cuda_int8full`."""
    if not _on_cuda(Q, P_i8, scales, qmask, pmask):
        return maxsim_int8full_plain(Q, P_i8, scales, qmask, pmask)
    return _launch_int8(maxsim_cuda_int8full_deferred, "maxsim_int8_defer",
                        "evdr_maxsim_int8full_defer", Q, P_i8, scales, qmask,
                        pmask, int8_queries=True)


def _check_int4(Q, P_u8, scales, qmask, pmask):
    if P_u8.dim() != 3:
        raise ValueError(f"packed codes must be 3-D, got {tuple(P_u8.shape)}")
    nd, lph, d = P_u8.shape
    lp = pmask.shape[-1]
    _check_shapes(Q, P_u8, qmask, pmask, scales, p_shape=(nd, lp, d))
    if lph != (lp + 1) // 2:
        raise ValueError(f"{lph} packed rows for {lp} tokens (want "
                         f"{(lp + 1) // 2})")
    if P_u8.dtype != torch.uint8 or scales.dtype != torch.float32:
        raise TypeError(f"K4 takes uint8 packed codes and f32 scales, got "
                        f"{P_u8.dtype} and {scales.dtype}")


def maxsim_cuda_int4(Q, P_u8, scales, qmask, pmask):
    """K4, int4 mode: bf16 queries x token-pair packed int4 codes
    (nd, ceil(Lp/2), D) uint8 with per-token scales (nd, Lp)."""
    if not _on_cuda(Q, P_u8, scales, qmask, pmask):
        return maxsim_int4_plain(Q, P_u8, scales, qmask, pmask)
    _check_int4(Q, P_u8, scales, qmask, pmask)
    return _launch(maxsim_cuda_int4, "maxsim_int4", "evdr_maxsim_int4",
                   Q.to(torch.bfloat16), qmask.float(), P_u8, scales, pmask)


def maxsim_cuda_int4full(Q, P_u8, scales, qmask, pmask):
    """K4, int4full mode: queries quantized per token on the device, then
    int8 x int4 (unpacked to int8) -> int32 on the tensor cores."""
    if not _on_cuda(Q, P_u8, scales, qmask, pmask):
        return maxsim_int4full_plain(Q, P_u8, scales, qmask, pmask)
    _check_int4(Q, P_u8, scales, qmask, pmask)
    Q_i8, qw = quantize_queries_int8(Q, qmask)
    return _launch(maxsim_cuda_int4full, "maxsim_int4",
                   "evdr_maxsim_int4full", Q_i8, qw, P_u8, scales, pmask)


def pq_cluster(nq: int, lq: int, compact: bool = False) -> int:
    """K3's cluster size C for nq queries of Lq tokens: the largest power of
    two <= MAX_CLUSTER (of compact or full-width books) that does not exceed
    the number of 128-row query blocks (1 for a single block). The launcher
    pads grid x up to a multiple of C."""
    n_blocks = -(-nq // (ROW_CAP["maxsim_pq"] // lq))
    top = MAX_CLUSTER["compact" if compact else "full"]
    c = 1
    while 2 * c <= min(top, n_blocks):
        c *= 2
    return c


def pq_occupancy(mode: str, d: int, m: int, cluster: int) -> tuple:
    """K3's (CTAs per SM, clusters of ``cluster`` CTAs the card holds at
    once) in ``mode`` 'pq', 'pqfull' or 'pq_sum', on the current GPU."""
    out = (ctypes.c_int * 2)()
    rc = _cuda_build.kernel("maxsim_pq", "evdr_pq_occupancy")(
        ("pq", "pqfull", "pq_sum").index(mode), d, m, cluster,
        ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"evdr_pq_occupancy failed: cudaError {rc}")
    return out[0], out[1]


def _wgmma_config(lib, func, *args) -> dict:
    out = (ctypes.c_int * 6)()
    rc = _cuda_build.kernel(lib, func)(*args, ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"{func} failed: cudaError {rc}")
    return dict(zip(("ctas_per_sm", "rows", "tile_tokens", "stages",
                     "consumer_warpgroups", "smem_bytes"), out))


def bf16_config(d: int, train: bool = False) -> dict:
    """The configuration K1 bf16 (``train``: K5 bf16) runs at width ``d``
    (a multiple of 16), on the current GPU (``maxsim_bf16.cu``'s rule by
    D)."""
    return _wgmma_config("maxsim_bf16", "evdr_bf16_config", d, int(train))


def int8full_wg_config(d: int) -> dict:
    """The configuration K2 int8full's wgmma kernel runs at width ``d`` (a
    multiple of 16, at most ``MAX_D``), on the current GPU
    (``maxsim_int8full_wg.cu``)."""
    return _wgmma_config("maxsim_int8", "evdr_int8full_wg_config", d)


def f32_occupancy(d: int, train: bool = False) -> tuple:
    """The tile configuration K1 float32 (``train``: K5 float32) runs at
    width ``d``, on the current GPU: (CTAs per SM, query-token rows,
    page-tile tokens)."""
    out = (ctypes.c_int * 3)()
    rc = _cuda_build.kernel("maxsim_f32", "evdr_f32_occupancy")(
        d, int(train), ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"evdr_f32_occupancy failed: cudaError {rc}")
    return tuple(out)


def _count(wrapper, func, nq, lq, nd, lp):
    wrapper.launches += 1
    launch_shapes[(wrapper.__name__, func, nq, lq, nd, lp)] += 1


def _count_index(lib, *operands):
    """Add the bytes of one launch's index operands to
    ``INDEX_BYTES_READ[lib]`` (None entries count nothing)."""
    INDEX_BYTES_READ[lib] += sum(t.numel() * t.element_size()
                                 for t in operands if t is not None)


def index_bytes_read() -> int:
    """Every library's index bytes covered by launches so far."""
    return sum(INDEX_BYTES_READ.values())


def func_launches(func: str) -> int:
    """Launches of kernel function ``func`` (e.g. a ``*_wide`` one) since
    the counts were last set to 0."""
    return sum(n for k, n in launch_shapes.items() if k[1] == func)


def _launch_pq(Qk, qw, codes, qmask, pmask, books, int8_queries):
    """K3's host side, then the launch: books quantized to int8 with one
    global scale (folded into ``qw``), padded to 256 rows. Compact books
    whose subvector width is a multiple of 4 bytes go to the kernel that
    holds them in shared memory and concatenates rows; any other books
    (expanded OPQ books, or compact ones embedded block-diagonally) to the
    kernel that sums full-width rows read through L2. ``Qk`` is int8 for
    the int8 x int8 loop, which needs compact books (an exact int8 tile);
    otherwise int8 queries score cast up to bf16 (exact). Above MAX_D the
    same three routes run on their wide functions, without clusters.
    Returns (scores, the kernel function launched)."""
    if codes.dim() != 3 or books.dim() != 3:
        raise ValueError("codes and books must be 3-D")
    nq, lq, d = Qk.shape
    nd, lp, m = codes.shape
    _check_shapes(Qk, codes, qmask, pmask, p_shape=(nd, lp, d))
    if codes.dtype != torch.uint8 or books.shape[0] != m:
        raise TypeError(f"K3 takes uint8 codes (nd, Lp, M={books.shape[0]}),"
                        f" got {codes.dtype} {tuple(codes.shape)}")
    compact, books_q, s = pq_books(books, d, codes.device)
    _, k, w = books_q.shape
    in_smem = compact and w % 4 == 0
    if in_smem:
        kb = torch.zeros((m, PQ_KMAX, w), dtype=torch.int8,
                         device=codes.device)
        kb[:, :k] = books_q
        func = "evdr_maxsim_pqfull" if int8_queries else "evdr_maxsim_pq"
    else:
        kb = pq_full_books(books_q, compact, d).to(torch.int8)
        func = "evdr_maxsim_pq_sum"
        if int8_queries:
            Qk = Qk.to(torch.bfloat16)
    out = torch.empty((nq, nd), dtype=torch.float32, device=codes.device)
    Qk = Qk.contiguous()
    wide = is_wide(func, d)
    func = kernel_func(func, d)
    cluster = 1 if wide else pq_cluster(nq, lq, in_smem)
    call_kernel("maxsim_pq", func, (Qk, (qw * s).contiguous(), codes, kb,
                                    pmask, out),
                nq, lq, nd, lp, d, m, cluster, aligned=(Qk, codes, kb))
    _count_index("maxsim_pq", codes, pmask)
    return out, func


def pq_width(m: int, w: int) -> int:
    """The subvector width compact (M, K, w) books run at: the smallest w'
    >= w with M w' a multiple of D_GRANULE."""
    wk = w
    while (m * wk) % D_GRANULE:
        wk += 1
    return wk


def pad_pq_queries(Q: torch.Tensor, m: int, w: int, wk: int) -> torch.Tensor:
    """(..., M w) queries -> (..., M wk): each subspace's w dims followed by
    wk - w zeros, to meet compact books padded by :func:`pq_width`."""
    if wk == w:
        return Q
    lead = Q.shape[:-1]
    return pad_dim(Q.reshape(*lead, m, w), wk).reshape(*lead, m * wk)


def pq_kernel_operands(Q, books):
    """Queries and books at the kernels' width: compact books pad each
    subspace's rows to :func:`pq_width` (zeros), and the queries each
    subspace to match; expanded (M, K, D) books and the queries pad their
    last axis to a multiple of D_GRANULE. Exact: the pad lanes are zero on
    both sides. Books that match neither layout pass through for
    :func:`pq_books` to refuse."""
    d = Q.shape[-1]
    dk = kernel_dim(d)
    m, _, w = books.shape
    if m > 1 and w == d:
        return pad_dim(Q, dk), pad_dim(books, dk)
    if m * w != d:
        return Q, books
    wk = pq_width(m, w)
    return pad_pq_queries(Q, m, w, wk), pad_dim(books, wk)


def _pq_launches(wrapper, Qk, qw, codes, pmask, books, int8_queries):
    """K3's launches: the operands at the kernels' width, then one launch
    per slice of at most ``row_cap('maxsim_pq', D)`` query tokens."""
    Qk, books = pq_kernel_operands(Qk, books)

    def one(qs, qws):
        out, func = _launch_pq(qs, qws, codes, qws, pmask, books,
                               int8_queries)
        _count(wrapper, func, qs.shape[0], qs.shape[1], *pmask.shape)
        return out

    return split_queries(one, Qk, qw, row_cap("maxsim_pq", Qk.shape[-1]))


def maxsim_cuda_pq(Q, codes, qmask, pmask, books):
    """K3, pq mode: bf16 queries against PQ codes (nd, Lp, M) uint8 and
    their f32 books, compact (M, K, D/M) or expanded OPQ (M, K, D)."""
    if not _on_cuda(Q, codes, qmask, pmask, books):
        return maxsim_pq_plain(Q, codes, qmask, pmask, books)
    return _pq_launches(maxsim_cuda_pq, Q.to(torch.bfloat16), qmask.float(),
                        codes, pmask, books, int8_queries=False)


def maxsim_cuda_pqfull(Q, codes, qmask, pmask, books):
    """K3, pqfull mode: queries quantized per token on the device; int8 x
    int8 against compact books, cast up to bf16 against expanded ones."""
    if not _on_cuda(Q, codes, qmask, pmask, books):
        return maxsim_pqfull_plain(Q, codes, qmask, pmask, books)
    Q_i8, qw = quantize_queries_int8(Q, qmask)
    return _pq_launches(maxsim_cuda_pqfull, Q_i8, qw, codes, pmask, books,
                        int8_queries=True)


KERNEL_WRAPPERS = (maxsim_cuda, maxsim_cuda_f32, maxsim_cuda_int8,
                   maxsim_cuda_int8full, maxsim_cuda_int8_deferred,
                   maxsim_cuda_int8full_deferred, maxsim_cuda_int4,
                   maxsim_cuda_int4full, maxsim_cuda_pq, maxsim_cuda_pqfull)
for _w in KERNEL_WRAPPERS:
    _w.launches = 0


def reset_launch_counts() -> None:
    """Zero the launch counts of every kernel wrapper of the port (this
    module's, ``cuda_maxsim_train``'s and ``pruned``'s stage 2)."""
    for w in all_wrappers():
        w.launches = 0
    launch_shapes.clear()


def launch_counts() -> dict:
    return {w.__name__: w.launches for w in all_wrappers()}


def all_wrappers() -> tuple:
    from evdr_tpu_torch.ops import cuda_maxsim_train, pruned

    return (KERNEL_WRAPPERS + cuda_maxsim_train.KERNEL_WRAPPERS
            + pruned.KERNEL_WRAPPERS)
