"""Convert interchange (pickled-object) feature npz -> dense packed npz.

The packed format is dense ``P_pad (N, L, D) float32`` (or bf16 bits, int8
codes + scales, packed int4 codes + scales, or PQ codes + codebooks)
``+ pmask (N, L) bool`` plus the query side and the eval maps, with no
object dtype. Files are interchangeable with
``evdr_tpu.tools.convert_packed`` for every storage type.

    python -m evdr_tpu_torch.tools.convert_packed --in_npz dump_all.npz \
        --out_npz dump_all.packed.npz [--length_multiple 16] \
        [--dtype float32|bfloat16|int8|int4|pq] [--normalize] \
        [--pq_m 16] [--pq_opq] [--device cpu]

``int4`` packs two codes per byte (ops/int4.py: ``P_codes4`` +
``P_scale``); ``pq`` product-quantizes to --pq_m bytes per token (ops/pq.py:
``P_pq_codes`` + ``P_pq_books``; ``--pq_opq`` adds an OPQ rotation folded
into expanded books, marked by ``P_pq_expanded``). Codebooks train on the
host; past 2M tokens the codes are encoded on the GPU (``--device cpu``
encodes there on the host with torch).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from evdr_tpu_torch.data.npz_io import load_payload
from evdr_tpu_torch.data.packing import (l2_normalize, preprocess_docs,
                                         preprocess_queries)
from evdr_tpu_torch.ops.int4 import dequantize_int4, quantize_tokens_int4
from evdr_tpu_torch.ops.pq import build_pq_index, decode_pq, encode_corpus
from evdr_tpu_torch.ops.quantize import dequantize_int8, quantize_tokens_int8

PACKED_DTYPES = ("float32", "bfloat16", "int8", "int4", "pq")


def bf16_bits(P: np.ndarray) -> np.ndarray:
    """float32 -> bf16 bit pattern as uint16 (round to nearest even, the
    same bits ml_dtypes writes)."""
    t = torch.from_numpy(np.ascontiguousarray(P, dtype=np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def bf16_bits_to_float32(bits: np.ndarray) -> np.ndarray:
    t = torch.from_numpy(np.ascontiguousarray(bits).view(np.int16))
    return t.view(torch.bfloat16).float().numpy()


def convert_payload_to_packed(payload: dict, length_multiple: int = 1,
                              dtype: str = "float32",
                              normalize: bool = False, pq_m: int = 16,
                              pq_opq: bool = False, device=None) -> dict:
    """``normalize=True`` stores doc tokens masked + L2-normalized and marks
    the file, which lets int8 and int4 serving consume their codes directly
    instead of dequantize -> normalize -> requantize. ``device``: where a
    PQ encode of more than 2M tokens runs (None: the GPU)."""
    if dtype not in PACKED_DTYPES:
        raise ValueError(f"dtype must be one of {PACKED_DTYPES}, got {dtype!r}")
    out = {}
    if payload.get("documents") is not None:
        P, pmask, _ = preprocess_docs(
            payload["documents"], payload.get("doc_attnmask"),
            payload.get("doc_imgmask"), length_multiple=length_multiple)
        if normalize:
            P = np.asarray(
                l2_normalize(P * pmask[..., None].astype(np.float32)),
                dtype=np.float32)
            out["doc_normalized"] = np.asarray(True)
        if dtype == "int8":
            out["P_codes"], out["P_scale"] = quantize_tokens_int8(P, pmask)
        elif dtype == "int4":
            out["P_codes4"], out["P_scale"] = quantize_tokens_int4(P, pmask)
        elif dtype == "pq":
            if payload.get("qat_books") is not None and not pq_opq:
                # a QAT-pq student: its own books, not a refit
                books = np.asarray(payload["qat_books"], np.float32)
                out["P_pq_codes"] = encode_corpus(P, books, pmask,
                                                  device=device)
            else:
                out["P_pq_codes"], books = build_pq_index(
                    P, pmask, m=pq_m, opq=pq_opq, device=device)
                if pq_opq:
                    # the rotation folded into full-width books: consumers
                    # score and decode them with sum semantics (ops/pq.py)
                    out["P_pq_expanded"] = np.asarray(True)
            out["P_pq_books"] = books
        elif dtype == "bfloat16":
            # np.load round-trips bf16 arrays as raw void: store the uint16
            # bit pattern under a marker key instead
            out["P_pad_bf16"] = bf16_bits(P)
        else:
            out["P_pad"] = P.astype(np.float32)
        out["pmask"] = pmask
    if payload.get("query") is not None:
        Q, qmask = preprocess_queries(
            payload["query"], payload.get("query_attnmask"),
            length_multiple=length_multiple)
        out["Q_norm"] = Q.astype(np.float32)
        out["qmask"] = qmask
    for key in ("docid", "qid", "qsidx_2_query"):
        if payload.get(key) is not None:
            out[key] = np.asarray([str(x) for x in payload[key]])
    # dict-valued maps ride as JSON strings (no pickling)
    for key in ("relevant_docs", "docidx_2_docid"):
        if payload.get(key) is not None:
            out[f"{key}_json"] = np.asarray(json.dumps(payload[key]))
    return out


def _npz_member_memmap(npz_path, name: str) -> np.ndarray:
    """Read-only np.memmap view of one STORED member of an (uncompressed)
    npz. ``np.savez`` writes members with ZIP_STORED, so the raw .npy bytes
    sit contiguously in the outer file: the zip local header and the npy
    header give the data offset, and the data is mapped directly (pages
    come from the OS cache, not from a copy in anonymous memory)."""
    import zipfile

    member = name if name.endswith(".npy") else name + ".npy"
    with zipfile.ZipFile(str(npz_path)) as zf:
        info = zf.getinfo(member)
        if info.compress_type != zipfile.ZIP_STORED:
            raise ValueError(
                f"{npz_path}:{member} is compressed; mmap needs np.savez "
                "(uncompressed), not savez_compressed")
        with zf.open(info) as m:
            version = np.lib.format.read_magic(m)
            if version == (1, 0):
                shape, fortran, dtype = np.lib.format.read_array_header_1_0(m)
            else:
                shape, fortran, dtype = np.lib.format.read_array_header_2_0(m)
            npy_header = m.tell()
    with open(str(npz_path), "rb") as f:
        f.seek(info.header_offset + 26)
        nlen = int.from_bytes(f.read(2), "little")
        elen = int.from_bytes(f.read(2), "little")
    data_off = info.header_offset + 30 + nlen + elen + npy_header
    return np.memmap(str(npz_path), dtype=dtype, mode="r", offset=data_off,
                     shape=shape, order="F" if fortran else "C")


def load_packed_payload(npz_path, mmap_docs: bool = False) -> dict:
    """Packed npz -> a payload-like dict with DENSE arrays.

    Returns keys: P_pad/pmask, Q_norm/qmask (dense, pre-normalized), plus the
    usual id/map keys decoded from JSON. bf16-stored docs are upcast to f32
    (exact); int8- and int4-stored docs are dequantized and PQ-stored docs
    decoded to ``P_pad``, while the raw codes (``P_codes``, ``P_codes4`` and
    ``P_scale``, ``P_pq_codes`` and ``P_pq_books``) ride along for engines
    that consume codes directly.

    ``mmap_docs=True`` returns the doc-axis arrays (``P_pad``, ``P_codes``,
    ``P_codes4``, ``P_scale``, ``pmask``, ``P_pq_codes``) as read-only
    np.memmap views and dequantizes or decodes nothing: an engine streams
    them to the device (``build_sharded_index(streaming=True)``). A
    bf16-stored file still materializes its upcast ``P_pad``.
    """
    mmap_keys = ({"P_pad", "P_codes", "P_codes4", "P_scale", "pmask",
                  "P_pq_codes"} if mmap_docs else set())
    out = {}
    with np.load(str(npz_path)) as z:  # no allow_pickle needed
        for k in z.files:
            if not k.endswith("_json"):
                out[k] = (_npz_member_memmap(npz_path, k) if k in mmap_keys
                          else z[k])
        decoded_json = {k: str(z[k]) for k in z.files if k.endswith("_json")}
    if "P_pad" in out and out["P_pad"].dtype != np.float32:
        out["P_pad"] = out["P_pad"].astype(np.float32)
    if "P_pad_bf16" in out:
        out["P_pad"] = bf16_bits_to_float32(out.pop("P_pad_bf16"))
    if not mmap_docs:
        # mmap mode leaves codes as they are: a dequantize or decode would
        # materialize the whole f32 tensor, the copy mmap exists to avoid
        if "P_codes" in out and "P_pad" not in out:
            out["P_pad"] = dequantize_int8(out["P_codes"], out["P_scale"])
        if "P_codes4" in out and "P_pad" not in out:
            out["P_pad"] = dequantize_int4(out["P_codes4"], out["P_scale"])
        if "P_pq_codes" in out and "P_pad" not in out:
            out["P_pad"] = decode_pq(out["P_pq_codes"], out["P_pq_books"],
                                     expanded=bool(out.get("P_pq_expanded",
                                                           False)))
    for key in ("relevant_docs", "docidx_2_docid"):
        jk = f"{key}_json"
        if jk in decoded_json:
            out[key] = json.loads(decoded_json[jk])
    return out


def is_packed(npz_path) -> bool:
    with np.load(str(npz_path), allow_pickle=True) as z:
        return ("P_pad" in z.files or "Q_norm" in z.files
                or "P_codes" in z.files or "P_pad_bf16" in z.files
                or "P_pq_codes" in z.files or "P_codes4" in z.files)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--in_npz", required=True)
    p.add_argument("--out_npz", required=True)
    p.add_argument("--length_multiple", type=int, default=1,
                   help="round padded lengths up (e.g. 16 for kernel tiles)")
    p.add_argument("--dtype", choices=PACKED_DTYPES, default="float32",
                   help="doc-token storage dtype (bfloat16 halves, int8 "
                        "quarters the file vs float32)")
    p.add_argument("--normalize", action="store_true",
                   help="store doc tokens masked + L2-normalized (enables "
                        "direct int8/int4-code serving without "
                        "requantization)")
    p.add_argument("--pq_m", type=int, default=16,
                   help="PQ subspaces = bytes/token (--dtype pq)")
    p.add_argument("--pq_opq", action="store_true",
                   help="learn an OPQ rotation before encoding (--dtype pq; "
                        "lower quantization error at the same bytes)")
    p.add_argument("--device", default=None,
                   help="where a PQ encode past 2M tokens runs: 'cuda' "
                        "(default) or 'cpu'")
    a = p.parse_args(argv)
    packed = convert_payload_to_packed(load_payload(a.in_npz),
                                       a.length_multiple, a.dtype,
                                       normalize=a.normalize, pq_m=a.pq_m,
                                       pq_opq=a.pq_opq, device=a.device)
    np.savez(a.out_npz, **packed)
    shapes = {k: getattr(v, "shape", None) for k, v in packed.items()}
    print(f"[packed] {a.out_npz}: {shapes}")


if __name__ == "__main__":
    main()
