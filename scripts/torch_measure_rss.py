"""Host memory of loading a packed index onto the GPU: eager against
memory-mapped streamed loading, for the torch port.

Writes a ``--normalize`` packed npz (int8 codes + scales by default, made
on the device a slab of pages at a time), then loads it through
``evdr_tpu_torch.RetrievalEngine.from_npz`` in a fresh subprocess per mode:

- eager: ``np.load`` reads every array into anonymous host memory, then
  the index is copied to the device;
- mmap: read-only ``np.memmap`` views of the file's members
  (``tools/convert_packed.load_packed_payload(mmap_docs=True)``) stream to
  the device a bounded chunk of rows at a time
  (``parallel/sharded_index.stream_rows``).

Each child reports ``ru_maxrss`` and, sampled every 5 ms while the load
runs, the peak ``RssAnon`` (anonymous memory: copies) and ``RssFile``
(mapped file pages, which the kernel can drop) above the child's own
baseline once its CUDA context is up, plus the load's seconds. Where
``/proc/self/status`` lacks those two fields, the sums of
``/proc/self/smaps``' ``Anonymous`` and ``Rss`` stand in (``rss_source``
says which); where neither splits anonymous from file-backed pages, the
child fails rather than report mapped file pages as anonymous. One search
checks that the loaded index serves.

    python scripts/torch_measure_rss.py [--n_docs 25000] [--lp 768] \
        [--dim 128] [--dtype int8|int4|float32] [--device cuda] \
        [--keep PATH]

The file goes under ``build/torch_rss/`` and is removed at the end unless
``--keep`` names it. The last line of the output is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import numpy as np

REPO = str(pathlib.Path(__file__).resolve().parent.parent)

_CHILD = r"""
import json, os, resource, sys, threading, time
sys.path.insert(0, {repo!r})
import torch
from evdr_tpu_torch import RetrievalEngine

device = torch.device({device!r})
if device.type == "cuda":
    torch.zeros(1, device=device)
    torch.cuda.synchronize()


# resident anonymous and file-backed MB: RssAnon and RssFile where
# /proc/self/status has them, else the sums of /proc/self/smaps' Anonymous
# and Rss - Anonymous. statm is no stand-in: a kernel that reports no
# shared pages there counts mapped file pages as anonymous.
def status():
    out = {{}}
    with open("/proc/self/status") as f:
        for line in f:
            key, _, val = line.partition(":")
            if key in ("RssAnon", "RssFile"):
                out[key] = float(val.split()[0]) / 1024.0
    if len(out) == 2:
        return out, "status"
    if os.path.exists("/proc/self/smaps"):
        rss = anon = 0.0
        with open("/proc/self/smaps") as f:
            for line in f:
                if line.startswith("Rss:"):
                    rss += float(line.split()[1])
                elif line.startswith("Anonymous:"):
                    anon += float(line.split()[1])
        if anon > 0:
            return {{"RssAnon": anon / 1024.0,
                    "RssFile": (rss - anon) / 1024.0}}, "smaps"
    raise SystemExit("neither /proc/self/status nor /proc/self/smaps "
                     "splits anonymous from file-backed pages")


base, source = status()
peak = dict(base)
stop = threading.Event()


def sample():
    while not stop.is_set():
        for key, val in status()[0].items():
            peak[key] = max(peak[key], val)
        time.sleep(0.005)


th = threading.Thread(target=sample, daemon=True)
th.start()
t0 = time.perf_counter()
eng = RetrievalEngine.from_npz({path!r}, mmap={mmap}, dtype={dtype!r},
                               device=device)
if device.type == "cuda":
    torch.cuda.synchronize()
load_s = time.perf_counter() - t0
stop.set()
th.join()
for key, val in status()[0].items():
    peak[key] = max(peak[key], val)
maxrss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
gen = torch.Generator(device=device).manual_seed(0)
Q = torch.randn((4, 8, eng.dim), device=device, generator=gen)
Q = Q / torch.linalg.vector_norm(Q, dim=-1, keepdim=True)
vals, idx = eng.search_dense(Q, torch.ones((4, 8), dtype=torch.bool,
                                           device=device), k=3)
assert idx.shape == (4, 3) and bool((idx < eng.n_docs).all())
print(json.dumps({{
    "load_s": load_s, "ru_maxrss_mb": maxrss,
    "baseline_anon_mb": base["RssAnon"], "baseline_file_mb": base["RssFile"],
    "peak_anon_above_baseline_mb": peak["RssAnon"] - base["RssAnon"],
    "peak_file_above_baseline_mb": peak["RssFile"] - base["RssFile"],
    "rss_source": source, "n_docs": eng.n_docs,
    "index_dtype": str(eng.index.P.dtype)}}))
"""


def write_packed(path, n_docs: int, lp: int, d: int, dtype: str,
                 device: str, slab: int = 1000) -> float:
    """A --normalize packed file of ``n_docs`` random unit pages (~10% of
    tokens masked), made on ``device`` a slab at a time; returns MB."""
    import torch

    sys.path.insert(0, REPO)
    from evdr_tpu_torch.ops.int4 import quantize_tokens_int4
    from evdr_tpu_torch.ops.quantize import quantize_tokens_int8

    gen = torch.Generator(device=device).manual_seed(0)
    out = {"doc_normalized": np.asarray(True),
           "pmask": np.empty((n_docs, lp), bool),
           "docid": np.asarray([f"page-{i}" for i in range(n_docs)])}
    if dtype == "int8":
        out["P_codes"] = np.empty((n_docs, lp, d), np.int8)
    elif dtype == "int4":
        out["P_codes4"] = np.empty((n_docs, (lp + 1) // 2, d), np.uint8)
    else:
        out["P_pad"] = np.empty((n_docs, lp, d), np.float32)
    if dtype != "float32":
        out["P_scale"] = np.empty((n_docs, lp), np.float32)
    for s in range(0, n_docs, slab):
        e = min(s + slab, n_docs)
        m = torch.rand((e - s, lp), device=device, generator=gen) > 0.1
        x = torch.randn((e - s, lp, d), device=device, generator=gen)
        x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        x = x * m[..., None]
        out["pmask"][s:e] = m.cpu().numpy()
        if dtype == "int8":
            codes, sc = quantize_tokens_int8(x, m)
            out["P_codes"][s:e] = codes.cpu().numpy()
        elif dtype == "int4":
            codes, sc = quantize_tokens_int4(x, m)
            out["P_codes4"][s:e] = codes.cpu().numpy()
        else:
            out["P_pad"][s:e] = x.cpu().numpy()
        if dtype != "float32":
            out["P_scale"][s:e] = sc.cpu().numpy()
    np.savez(path, **out)
    return pathlib.Path(path).stat().st_size / 1e6


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n_docs", type=int, default=25_000)
    ap.add_argument("--lp", type=int, default=768)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--dtype", choices=("int8", "int4", "float32"),
                    default="int8")
    ap.add_argument("--device", default="cuda",
                    help="where the pages are made and the index is loaded")
    ap.add_argument("--keep", default=None,
                    help="reuse or keep the packed file at this path")
    a = ap.parse_args(argv)

    tmp = pathlib.Path(REPO) / "build" / "torch_rss"
    path = pathlib.Path(a.keep) if a.keep else tmp / "rss.packed.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    if not path.exists():
        mb = write_packed(path, a.n_docs, a.lp, a.dim, a.dtype, a.device)
        print(f"[rss] wrote {path}: {mb:.1f} MB", flush=True)
    file_mb = path.stat().st_size / 1e6
    eng_dtype = a.dtype if a.dtype in ("int8", "int4") else None
    results = {}
    try:
        for mode, mm in (("eager", False), ("mmap", True)):
            code = _CHILD.format(repo=REPO, path=str(path), mmap=mm,
                                 dtype=eng_dtype, device=a.device)
            out = subprocess.run([sys.executable, "-c", code],
                                 capture_output=True, text=True, timeout=900)
            if out.returncode != 0:
                print(out.stderr[-3000:], file=sys.stderr)
                raise SystemExit(f"{mode} load failed")
            results[mode] = json.loads(out.stdout.strip().splitlines()[-1])
            print(f"[rss] {mode}: {results[mode]}", flush=True)
    finally:
        if not a.keep:
            path.unlink(missing_ok=True)
    report = {"file_mb": file_mb, "dtype": a.dtype, "n_docs": a.n_docs,
              "lp": a.lp, "dim": a.dim, "device": a.device,
              "eager": results["eager"], "mmap": results["mmap"]}
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
