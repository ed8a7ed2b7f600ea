"""Boundaries of the torch port: it never imports JAX or the JAX package,
it refuses to carry on on the CPU unless asked, its kernel wrappers take the
plain path only for CPU tensors, and chip_smoke.py fails without a GPU."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import evdr_tpu_torch
from evdr_tpu_torch import RetrievalEngine
from evdr_tpu_torch.ops import _cuda_build, cuda_maxsim, cuda_maxsim_train
from evdr_tpu_torch.tools import search

ROOT = Path(__file__).resolve().parents[1]


def _run(code, cwd=ROOT, timeout=120):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import evdr_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    evdr_tpu_torch.__path__, 'evdr_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'evdr_tpu'))\n"
        "new = [m for m in ('evdr_tpu_torch.ops.batched_kmeans',\n"
        "                   'evdr_tpu_torch.ops.pruned') if m in mods]\n"
        "print(len(mods), len(new), bad)\n")
    r = _run(code)
    assert r.returncode == 0, r.stderr
    n, n_new, bad = r.stdout.split(" ", 2)
    assert int(n) >= 38 and int(n_new) == 2 and bad.strip() == "[]", r.stdout
    # chip_smoke.py too, as a script
    r = _run("import runpy, sys\n"
             "sys.argv = ['chip_smoke.py']\n"
             "try:\n"
             "    runpy.run_path('chip_smoke.py', run_name='not_main')\n"
             "finally:\n"
             "    print(sorted(k for k in sys.modules if k.split('.')[0] in "
             "('jax', 'jaxlib', 'evdr_tpu')))\n")
    assert r.returncode == 0 and r.stdout.strip() == "[]", r.stdout + r.stderr


def test_sources_name_no_jax_import():
    files = list(Path(evdr_tpu_torch.__file__).parent.rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax",
                                     "import evdr_tpu ", "from evdr_tpu.",
                                     "from evdr_tpu ")), f"{f}: {line}"


def test_engine_and_clis_raise_without_a_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RetrievalEngine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RetrievalEngine(device="cuda")
    path = tmp_path / "x.npz"
    np.savez(path, P_pad=np.zeros((2, 3, 16), np.float32),
             pmask=np.ones((2, 3), bool), Q_norm=np.zeros((1, 2, 16),
                                                          np.float32),
             qmask=np.ones((1, 2), bool))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        search.main(["--index", str(path), "--queries", str(path)])
    for dtype in ("int4", "pq"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            RetrievalEngine(dtype=dtype, pq_opq=True)
    # the corpus-scale PQ encoder places numpy input on the GPU by default
    from evdr_tpu_torch.ops.pq import encode_pq_device

    with pytest.raises(RuntimeError, match="no CUDA device"):
        encode_pq_device(np.zeros((1, 2, 16), np.float32),
                         np.zeros((4, 2, 4), np.float32))
    assert RetrievalEngine(device="cpu").impl == "plain"
    assert RetrievalEngine(dtype="int8", quantize_queries=True,
                           device="cpu").impl == "plain_q8"
    # meshes, NCCL groups and multi-process serving need the GPU too
    from evdr_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d, mesh_of
    from evdr_tpu_torch.parallel.multihost import init_multihost
    from evdr_tpu_torch.tools import serve_http

    for make in (make_mesh, lambda: make_mesh(2), lambda: make_mesh_2d(1, 1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RetrievalEngine(mesh=mesh_of(["cuda:0"] * 4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_multihost("localhost:1", 2, 0, "nccl")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_http.main(["--index", str(path), "--multihost",
                         "--coordinator", "localhost:1",
                         "--num_processes", "2", "--process_id", "0"])
    with pytest.raises(ValueError, match="backend must be one of"):
        init_multihost("localhost:1", 2, 0, "mpi")
    assert RetrievalEngine(mesh=mesh_of(["cpu"] * 4)).impl == "plain"


def test_wrappers_route_cpu_tensors_to_plain_versions():
    rng = np.random.default_rng(0)
    Q = torch.from_numpy(rng.normal(size=(3, 5, 16)).astype(np.float32))
    P = torch.from_numpy(rng.normal(size=(4, 6, 16)).astype(np.float32))
    qm = torch.ones(3, 5, dtype=torch.bool)
    pm = torch.from_numpy(rng.random((4, 6)) > 0.3)
    codes = torch.from_numpy(rng.integers(-127, 128, (4, 6, 16), np.int8))
    sc = torch.from_numpy(rng.random((4, 6)).astype(np.float32))
    packed = torch.from_numpy(rng.integers(0, 256, (4, 3, 16), np.uint8))
    pq_codes = torch.from_numpy(rng.integers(0, 8, (4, 6, 4), np.uint8))
    books = torch.from_numpy(rng.normal(size=(4, 8, 4)).astype(np.float32))
    before = cuda_maxsim.launch_counts()
    pairs = [(cuda_maxsim.maxsim_cuda(Q, P, qm, pm),
              cuda_maxsim.maxsim_plain(Q, P, qm, pm)),
             (cuda_maxsim.maxsim_cuda_int8(Q, codes, sc, qm, pm),
              cuda_maxsim.maxsim_int8_plain(Q, codes, sc, qm, pm)),
             (cuda_maxsim.maxsim_cuda_int8full(Q, codes, sc, qm, pm),
              cuda_maxsim.maxsim_int8full_plain(Q, codes, sc, qm, pm)),
             (cuda_maxsim.maxsim_cuda_int4(Q, packed, sc, qm, pm),
              cuda_maxsim.maxsim_int4_plain(Q, packed, sc, qm, pm)),
             (cuda_maxsim.maxsim_cuda_int4full(Q, packed, sc, qm, pm),
              cuda_maxsim.maxsim_int4full_plain(Q, packed, sc, qm, pm)),
             (cuda_maxsim.maxsim_cuda_pq(Q, pq_codes, qm, pm, books),
              cuda_maxsim.maxsim_pq_plain(Q, pq_codes, qm, pm, books)),
             (cuda_maxsim.maxsim_cuda_pqfull(Q, pq_codes, qm, pm, books),
              cuda_maxsim.maxsim_pqfull_plain(Q, pq_codes, qm, pm, books))]
    for got, want in pairs:
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert cuda_maxsim.launch_counts() == before  # no kernel launched
    with pytest.raises(ValueError, match="one device"):
        cuda_maxsim.maxsim_cuda(Q, P.to("meta"), qm, pm)


def test_kernel_build_is_keyed_on_every_source(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_cuda_build.CSRC, csrc)
    monkeypatch.setattr(_cuda_build, "CSRC", csrc)
    monkeypatch.setattr(_cuda_build, "BUILD_ROOT", tmp_path / "build")
    first = _cuda_build.library_path("maxsim_int8")
    (csrc / "maxsim_tile.cuh").write_text(
        (csrc / "maxsim_tile.cuh").read_text() + "\n// edited\n")
    second = _cuda_build.library_path("maxsim_int8")
    assert first != second and second.parent.parent == tmp_path / "build"
    built = [f.name for n in _cuda_build.LIBRARIES
             for f in _cuda_build.sources(n)]
    assert sorted(built) == sorted(p.name for p in csrc.glob("*.cu"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda_build.build_all()


def test_library_map_matches_each_sources_exports():
    """Each library's ctypes map (``_cuda_build.LIBRARIES``) names exactly
    the ``extern "C"`` functions its sources export, each with one argtype
    per parameter: c_void_p for a pointer (the stream included), c_int for
    an int (K5's exports live in K1's libraries, K6's in maxsim_train, K2
    int8full's wgmma kernel in K2's)."""
    import ctypes
    import re

    for lib, funcs in _cuda_build.LIBRARIES.items():
        src = "".join(f.read_text() for f in _cuda_build.sources(lib))
        found = {name: [ctypes.c_void_p if "*" in p else ctypes.c_int
                        for p in params.split(",")]
                 for name, params in re.findall(
                     r'extern "C" int (\w+)\(([^)]*)\)', src)}
        assert found == funcs, lib
    assert "evdr_maxsim_fwd_train" in _cuda_build.LIBRARIES["maxsim_bf16"]
    assert "evdr_maxsim_fwd_train_f32" in _cuda_build.LIBRARIES["maxsim_f32"]
    assert "evdr_maxsim_int8full_wg" in _cuda_build.LIBRARIES["maxsim_int8"]


def test_chip_smoke_fails_without_a_gpu_or_the_package(tmp_path):
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and '"ok"' not in r.stdout
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    r = subprocess.run([sys.executable, str(lone)], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and '"ok"' not in r.stdout


@pytest.mark.gpu
@pytest.mark.parametrize("nq,lq,nd,lp,d", [
    (9, 7, 13, 71, 32), (7, 128, 5, 65, 48), (9, 3, 6, 200, 256),
    (300, 33, 17, 64, 64), (130, 5, 11, 64, 16)])
def test_cuda_kernels_match_plain_versions_on_the_card(nq, lq, nd, lp, d):
    """The three kernels against their plain versions at ragged shapes (Lq,
    Lp, nd and D off the tile sizes, D not a multiple of 32 int8 lanes).
    The kernels differ from the plain versions only in summation order:
    f32 sums of <= 128 unit-bounded terms -> 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from evdr_tpu_torch.ops.quantize import quantize_tokens_int8

    rng = np.random.default_rng(nq + lq + d)
    dev = "cuda"
    Q = torch.from_numpy(rng.normal(size=(nq, lq, d)).astype(np.float32))
    Q = (Q / Q.norm(dim=-1, keepdim=True)).to(dev)
    P = torch.from_numpy(rng.normal(size=(nd, lp, d)).astype(np.float32))
    P = (P / P.norm(dim=-1, keepdim=True)).to(dev)
    qm = torch.from_numpy(rng.random((nq, lq)) > 0.2).to(dev)
    pm = torch.from_numpy(rng.random((nd, lp)) > 0.2).to(dev)
    pm[nd // 2] = False
    codes, sc = quantize_tokens_int8(P, pm)
    n0 = dict(cuda_maxsim.launch_counts())
    for kern, plain, args in [
            (cuda_maxsim.maxsim_cuda, cuda_maxsim.maxsim_plain,
             (Q, P.to(torch.bfloat16), qm, pm)),
            (cuda_maxsim.maxsim_cuda_int8, cuda_maxsim.maxsim_int8_plain,
             (Q, codes, sc, qm, pm)),
            (cuda_maxsim.maxsim_cuda_int8full,
             cuda_maxsim.maxsim_int8full_plain, (Q, codes, sc, qm, pm))]:
        got = kern(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, plain(*args), rtol=0, atol=1e-4)
        assert got[:, nd // 2].abs().max().item() == 0.0
        n = cuda_maxsim.launch_counts()[kern.__name__]
        assert n == n0[kern.__name__] + 1


@pytest.mark.gpu
@pytest.mark.parametrize("nq,lq,nd,lp,d", [
    (9, 7, 13, 71, 32), (7, 128, 5, 65, 48), (9, 3, 6, 201, 256),
    (300, 33, 17, 64, 64), (130, 5, 11, 1, 16)])
def test_int4_and_pq_kernels_match_plain_versions_on_the_card(nq, lq, nd, lp,
                                                              d):
    """K4 (both modes) and K3 (compact books in shared memory, compact
    books of 2-byte subvectors and expanded books with K < 256, both
    through the L2 sum decode; pq and pqfull) against their plain versions
    at ragged shapes (odd Lp, Lp = 1, D off the tile sizes), with a doc that
    has no valid token. Summation order alone differs: f32 sums of <= 128
    terms of magnitude <= ~2 -> 1e-4 (and 1e-5 relative)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from evdr_tpu_torch.ops.int4 import quantize_tokens_int4

    torch.set_float32_matmul_precision("highest")
    rng = np.random.default_rng(nq + lq + d)
    dev = "cuda"

    def unit(*shape):
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        return (x / x.norm(dim=-1, keepdim=True)).to(dev)

    Q = unit(nq, lq, d)
    qm = torch.from_numpy(rng.random((nq, lq)) > 0.2).to(dev)
    pm = torch.from_numpy(rng.random((nd, lp)) > 0.2).to(dev)
    pm[nd // 2] = False
    packed, sc = quantize_tokens_int4(unit(nd, lp, d), pm)
    books = {  # name -> (books, largest code)
        "compact": (unit(d // 4, 256, 4) * 0.5, 256),
        "compact2": (unit(d // 2, 200, 2) * 0.5, 200),
        "expanded": (unit(4, 40, d) * 0.5, 256)}
    cases = [(cuda_maxsim.maxsim_cuda_int4, cuda_maxsim.maxsim_int4_plain,
              (Q, packed, sc, qm, pm)),
             (cuda_maxsim.maxsim_cuda_int4full,
              cuda_maxsim.maxsim_int4full_plain, (Q, packed, sc, qm, pm))]
    for b, top in books.values():
        codes = torch.from_numpy(rng.integers(0, top, (nd, lp, b.shape[0]),
                                              np.uint8)).to(dev)
        cases += [(cuda_maxsim.maxsim_cuda_pq, cuda_maxsim.maxsim_pq_plain,
                   (Q, codes, qm, pm, b)),
                  (cuda_maxsim.maxsim_cuda_pqfull,
                   cuda_maxsim.maxsim_pqfull_plain, (Q, codes, qm, pm, b))]
    for kern, plain, args in cases:
        n0 = cuda_maxsim.launch_counts()[kern.__name__]
        got = kern(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, plain(*args), rtol=1e-5, atol=1e-4)
        assert got[:, nd // 2].abs().max().item() == 0.0
        assert cuda_maxsim.launch_counts()[kern.__name__] == n0 + 1


def _untie(Q, qm, P, pm, gap=1e-5, dtype=torch.bfloat16):
    """Mask out each runner-up page token whose exact similarity (f64, on
    the operands rounded to the compute ``dtype``) to a valid query row lies
    within ``gap`` of that row's max for its doc: another f32 summation
    order could make it the argmax, and K6's indicator would then move a
    whole token's gradient (chip_smoke.untie does the same at the train
    step's shape)."""
    if P.shape[1] < 2:
        return  # one token a page: nothing to tie with
    rows = Q.to(dtype).double().reshape(-1, Q.shape[-1])
    rows = rows[qm.reshape(-1)]
    for _ in range(3):
        sim = torch.einsum("rd,cmd->rcm", rows, P.to(dtype).double())
        top = sim.masked_fill(~pm[None], float("-inf")).topk(2, dim=-1)
        v = top.values
        r, c = ((v[..., 0] - v[..., 1] < gap)
                & torch.isfinite(v[..., 1])).nonzero(as_tuple=True)
        if len(r) == 0:
            return
        pm[c, top.indices[r, c, 1]] = False
    raise AssertionError("near-ties remain")


@pytest.mark.gpu
@pytest.mark.parametrize("nq,lq,nd,lp,d", [
    (9, 7, 13, 71, 32), (7, 128, 5, 65, 64), (300, 33, 17, 64, 128),
    (40, 32, 300, 154, 96)])
def test_train_kernels_match_plain_versions_on_the_card(nq, lq, nd, lp, d):
    """K1-f32, K5 and K6 against their plain versions at ragged shapes, with
    a doc that has no valid token, on tie-free data (``_untie``).
    Summation order alone differs: K1-f32 and K5 within 1e-4; K6's dQ and
    dP within 1e-3 relative (Frobenius)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.set_float32_matmul_precision("highest")
    rng = np.random.default_rng(nq + lq + d)
    dev = "cuda"
    Q = torch.from_numpy(rng.normal(size=(nq, lq, d)).astype(np.float32))
    Q = (Q / Q.norm(dim=-1, keepdim=True)).to(dev)
    P = torch.from_numpy(rng.normal(size=(nd, lp, d)).astype(np.float32))
    P = (P / P.norm(dim=-1, keepdim=True)).to(dev)
    qm = torch.from_numpy(rng.random((nq, lq)) > 0.2).to(dev)
    pm = torch.from_numpy(rng.random((nd, lp)) > 0.2).to(dev)
    pm[nd // 2] = False
    _untie(Q, qm, P, pm)
    g = torch.from_numpy(rng.normal(size=(nq, nd)).astype(np.float32)).to(dev)
    n0 = dict(cuda_maxsim.launch_counts())
    got = cuda_maxsim.maxsim_cuda_f32(Q, P, qm, pm)
    torch.testing.assert_close(
        got, cuda_maxsim.maxsim_plain(Q, P, qm, pm, compute=torch.float32),
        rtol=0, atol=1e-4)
    out, M = cuda_maxsim_train.maxsim_cuda_fwd_train(Q, P, qm, pm)
    out_p, M_p = cuda_maxsim_train.maxsim_fwd_train_plain(Q, P, qm, pm)
    torch.testing.assert_close(out, out_p, rtol=0, atol=1e-4)
    torch.testing.assert_close(M, M_p, rtol=0, atol=1e-4)
    dq, dp = cuda_maxsim_train.maxsim_cuda_bwd(Q, P, qm, pm, M, g)
    dq_p, dp_p = cuda_maxsim_train.maxsim_bwd_plain(Q, P, qm, pm, M_p, g)
    for a, b in ((dq, dq_p), (dp, dp_p)):
        assert float((a - b).norm() / b.norm()) <= 1e-3
    assert float(dp[nd // 2].abs().max()) == 0.0
    # K6 launches once per chunk of MAX_QB_BLOCKS 128-row query blocks
    n_qb = -(-nq // (128 // lq))
    want = {"maxsim_cuda_f32": 1, "maxsim_cuda_fwd_train": 1,
            "maxsim_cuda_bwd": -(-n_qb // cuda_maxsim_train.MAX_QB_BLOCKS)}
    counts = cuda_maxsim.launch_counts()
    for name, n in want.items():
        assert counts[name] == n0[name] + n


@pytest.mark.gpu
@pytest.mark.parametrize("nq,lq,nd,lp,d", [
    (9, 7, 13, 71, 32), (7, 128, 5, 65, 64), (300, 33, 17, 64, 128),
    (40, 32, 300, 155, 96), (5, 16, 9, 1, 128)])
def test_f32_train_kernels_match_plain_versions_on_the_card(nq, lq, nd, lp,
                                                            d):
    """K5 and K6 in float32 mode against their plain float32 versions at
    ragged shapes (odd Lp, Lp = 1, D 32-128, several query blocks), with a
    doc that has no valid token, on tie-free data. K5's 3xTF32 products
    (which K6 recomputes) against full-f32 ones: K5's scores and M within
    1e-4, K6's dQ and dP within 1e-4 relative (Frobenius); K5's scores
    equal K1 float32's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.set_float32_matmul_precision("highest")
    ct = cuda_maxsim_train
    rng = np.random.default_rng(nq + lq + lp + d)
    dev = "cuda"
    Q = torch.from_numpy(rng.normal(size=(nq, lq, d)).astype(np.float32))
    Q = (Q / Q.norm(dim=-1, keepdim=True)).to(dev)
    P = torch.from_numpy(rng.normal(size=(nd, lp, d)).astype(np.float32))
    P = (P / P.norm(dim=-1, keepdim=True)).to(dev)
    qm = torch.from_numpy(rng.random((nq, lq)) > 0.2).to(dev)
    qm[:, 0] = True
    pm = torch.from_numpy(rng.random((nd, lp)) > 0.2).to(dev)
    pm[:, 0] = True
    pm[nd // 2] = False
    _untie(Q, qm, P, pm, dtype=torch.float32)
    g = torch.from_numpy(rng.normal(size=(nq, nd)).astype(np.float32)).to(dev)
    n0 = dict(cuda_maxsim.launch_counts())
    out, M = ct.maxsim_cuda_fwd_train(Q, P, qm, pm, torch.float32)
    out_p, M_p = ct.maxsim_fwd_train_plain(Q, P, qm, pm, torch.float32)
    torch.testing.assert_close(out, out_p, rtol=0, atol=1e-4)
    torch.testing.assert_close(M, M_p, rtol=0, atol=1e-4)
    assert torch.equal(out, cuda_maxsim.maxsim_cuda_f32(Q, P, qm, pm))
    dq, dp = ct.maxsim_cuda_bwd(Q, P, qm, pm, M, g, torch.float32)
    dq_p, dp_p = ct.maxsim_bwd_plain(Q, P, qm, pm, M_p, g, torch.float32)
    for a, b in ((dq, dq_p), (dp, dp_p)):
        assert float((a - b).norm() / b.norm()) <= 1e-4
    assert float(out[:, nd // 2].abs().max()) == 0.0
    assert float(dp[nd // 2].abs().max()) == 0.0
    n_qb = -(-nq // (128 // lq))
    want = {"maxsim_cuda_fwd_train_f32": 1, "maxsim_cuda_f32": 1,
            "maxsim_cuda_bwd_f32": -(-n_qb // ct.MAX_QB_BLOCKS),
            "maxsim_cuda_fwd_train": 0, "maxsim_cuda_bwd": 0}
    counts = cuda_maxsim.launch_counts()
    for name, n in want.items():
        assert counts[name] == n0[name] + n, name


@pytest.mark.gpu
def test_maxsimfn_f32_end_to_end_on_the_card():
    """maxsim(impl='pallas', compute_dtype=float32) under autograd on CUDA
    tensors runs K5 f32 then K6 f32, and its scores and gradients match the
    same call on CPU copies (the plain float32 versions) within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from evdr_tpu_torch.ops.maxsim import maxsim

    torch.set_float32_matmul_precision("highest")
    rng = np.random.default_rng(5)
    Q = torch.from_numpy(rng.normal(size=(24, 20, 128)).astype(np.float32))
    Q = Q / Q.norm(dim=-1, keepdim=True)
    P = torch.from_numpy(rng.normal(size=(40, 77, 128)).astype(np.float32))
    P = P / P.norm(dim=-1, keepdim=True)
    qm = torch.from_numpy(rng.random((24, 20)) > 0.2)
    pm = torch.from_numpy(rng.random((40, 77)) > 0.2)
    pm[3] = False
    _untie(Q, qm, P, pm, dtype=torch.float32)
    g = torch.from_numpy(rng.normal(size=(24, 40)).astype(np.float32))
    grads = []
    n0 = dict(cuda_maxsim.launch_counts())
    for dev in ("cuda", "cpu"):
        q = Q.to(dev).requires_grad_(True)
        p = P.to(dev).requires_grad_(True)
        out = maxsim(q, p, qm.to(dev), pm.to(dev), impl="pallas",
                     compute_dtype=torch.float32)
        out.backward(g.to(dev))
        grads.append([out.detach().cpu(), q.grad.cpu(), p.grad.cpu()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    counts = cuda_maxsim.launch_counts()
    for name in ("maxsim_cuda_fwd_train_f32", "maxsim_cuda_bwd_f32"):
        assert counts[name] == n0[name] + 1, name


@pytest.mark.gpu
@pytest.mark.parametrize("nq,lq,nd,lp,d", [
    (9, 7, 13, 71, 32), (7, 128, 5, 65, 48), (256, 32, 301, 64, 128),
    (130, 5, 11, 1, 16), (33, 17, 900, 20, 64), (3, 129, 40, 64, 128),
    (2, 256, 30, 767, 64), (5, 200, 20, 768, 128), (4, 256, 9, 64, 16)])
def test_deferred_int8_kernels_equal_k2_on_the_card(nq, lq, nd, lp, d):
    """K2b (both modes) against K2 on the same inputs: bit-equal (the same
    sums in the same order); and within K2's tolerance of the plain version,
    at odd Lp, Lp = 1 (a doc ends every tile) and many doc blocks, with a
    doc that has no valid token."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from evdr_tpu_torch.ops.quantize import quantize_tokens_int8

    torch.set_float32_matmul_precision("highest")
    rng = np.random.default_rng(nq + lq + lp + d)
    dev = "cuda"
    Q = torch.from_numpy(rng.normal(size=(nq, lq, d)).astype(np.float32))
    Q = (Q / Q.norm(dim=-1, keepdim=True)).to(dev)
    P = torch.from_numpy(rng.normal(size=(nd, lp, d)).astype(np.float32))
    P = (P / P.norm(dim=-1, keepdim=True)).to(dev)
    qm = torch.from_numpy(rng.random((nq, lq)) > 0.2).to(dev)
    pm = torch.from_numpy(rng.random((nd, lp)) > 0.2).to(dev)
    pm[nd // 2] = False
    codes, sc = quantize_tokens_int8(P, pm)
    args = (Q, codes, sc, qm, pm)
    for k2, k2b, plain in [
            (cuda_maxsim.maxsim_cuda_int8,
             cuda_maxsim.maxsim_cuda_int8_deferred,
             cuda_maxsim.maxsim_int8_plain),
            (cuda_maxsim.maxsim_cuda_int8full,
             cuda_maxsim.maxsim_cuda_int8full_deferred,
             cuda_maxsim.maxsim_int8full_plain)]:
        n0 = cuda_maxsim.launch_counts()
        got = k2(*args, deferred=True)
        want = k2(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        torch.testing.assert_close(got, plain(*args), rtol=0, atol=1e-4)
        assert got[:, nd // 2].abs().max().item() == 0.0
        n = cuda_maxsim.launch_counts()
        assert n[k2b.__name__] == n0[k2b.__name__] + 1
        assert n[k2.__name__] == n0[k2.__name__] + 1


def _int8full_both(Q, codes, sc, qm, pm):
    """K2 int8full's wgmma kernel and its mma.sync loop on the same
    operands, each through ``call_kernel``: (wgmma scores, mma.sync
    scores)."""
    cm = cuda_maxsim
    nq, lq, d = Q.shape
    nd, lp = pm.shape
    qk, qw = cm.quantize_queries_int8(Q, qm)
    outs = []
    for func in ("evdr_maxsim_int8full_wg", "evdr_maxsim_int8full"):
        out = torch.full((nq, nd), float("nan"), device=Q.device)
        cm.call_kernel("maxsim_int8", func, (qk, qw, codes, sc, pm, out),
                       nq, lq, nd, lp, d, aligned=(qk, codes))
        outs.append(out)
    torch.cuda.synchronize()
    return outs


@pytest.mark.gpu
@pytest.mark.parametrize("lp,d,lq,nq", [
    (64, 128, 32, 9), (65, 96, 20, 13), (700, 256, 32, 17),
    (768, 128, 20, 25), (768, 96, 32, 9), (65, 256, 32, 8),
    (700, 128, 20, 13), (64, 256, 20, 5), (768, 256, 32, 33)])
def test_int8full_wgmma_kernel_equals_mma_sync_loop_on_the_card(lp, d, lq,
                                                                 nq):
    """K2 int8full's wgmma kernel against its mma.sync loop on the same
    operands: bit-equal scores (int32 sums exact in any k order, the
    conversion folded into the accumulator exact, one rounding of the
    scale, the Lq-sum in the same order), at Lp 64, 65, 700 and 768 (a
    doc's ragged last tile beside the next doc's tokens, the last doc's
    read past the tensor's end), D 96 (a zero-filled box), 128 and 256
    (two column chunks), Lq 32 and 20 (12 whole queries a CTA, 16 rows
    empty), nq off the queries a CTA, 37 docs (a partial doc block), with
    masked page and query tokens, a valid token of scale 0 and a doc with
    no valid token. The wrapper takes the wgmma kernel there (counted) and
    stays within 1e-4 of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from evdr_tpu_torch.ops.quantize import quantize_tokens_int8

    torch.set_float32_matmul_precision("highest")
    cm = cuda_maxsim
    rng = np.random.default_rng(lp + d + lq + nq)
    nd, dev = 37, "cuda"
    Q = torch.from_numpy(rng.normal(size=(nq, lq, d)).astype(np.float32))
    Q = (Q / Q.norm(dim=-1, keepdim=True)).to(dev)
    P = torch.from_numpy(rng.normal(size=(nd, lp, d)).astype(np.float32))
    P = (P / P.norm(dim=-1, keepdim=True)).to(dev)
    qm = torch.from_numpy(rng.random((nq, lq)) > 0.2).to(dev)
    pm = torch.from_numpy(rng.random((nd, lp)) > 0.2).to(dev)
    pm[nd // 2] = False
    P[3, 0] = 0.0  # a valid token of scale 0
    pm[3, 0] = True
    codes, sc = quantize_tokens_int8(P, pm)
    assert float(sc[3, 0]) == 0.0
    wg, mma = _int8full_both(Q, codes, sc, qm, pm)
    assert torch.equal(wg, mma)
    assert wg[:, nd // 2].abs().max().item() == 0.0
    cm.reset_launch_counts()
    got = cm.maxsim_cuda_int8full(Q, codes, sc, qm, pm)
    torch.cuda.synchronize()
    assert cm.func_launches("evdr_maxsim_int8full_wg") == 1
    assert torch.equal(got, wg)
    torch.testing.assert_close(
        got, cm.maxsim_int8full_plain(Q, codes, sc, qm, pm), rtol=0,
        atol=1e-4)
    cfg = cm.int8full_wg_config(d)
    assert (cfg["rows"], cfg["tile_tokens"]) == (256, 128)
    assert cfg["ctas_per_sm"] >= 1 and cfg["smem_bytes"] <= 232448


@pytest.mark.gpu
def test_int8full_wgmma_kernel_equals_mma_sync_loop_past_2gb_on_the_card():
    """An index of more than 2^31 bytes (22,000 x 768 x 128 int8): the
    wgmma kernel's scores equal the mma.sync loop's bit for bit, and its
    last pages equal the plain version's (1e-4), so no byte offset wraps
    at 32 bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.set_float32_matmul_precision("highest")
    cm = cuda_maxsim
    nd, lp, d, nq, lq, dev = 22_000, 768, 128, 9, 32, "cuda"
    assert nd * lp * d > 2 ** 31
    gen = torch.Generator(device=dev).manual_seed(0)
    codes = torch.randint(-127, 128, (nd, lp, d), dtype=torch.int8,
                          device=dev, generator=gen)
    sc = torch.rand((nd, lp), device=dev, generator=gen) / 127
    pm = torch.rand((nd, lp), device=dev, generator=gen) > 0.1
    pm[-2] = False
    Q = torch.randn((nq, lq, d), device=dev, generator=gen)
    Q = Q / Q.norm(dim=-1, keepdim=True)
    qm = torch.rand((nq, lq), device=dev, generator=gen) > 0.15
    wg, mma = _int8full_both(Q, codes, sc, qm, pm)
    assert torch.equal(wg, mma)
    tail = slice(nd - 64, nd)
    torch.testing.assert_close(
        wg[:, tail], cm.maxsim_int8full_plain(
            Q, codes[tail], sc[tail], qm, pm[tail]), rtol=0, atol=1e-4)
    assert wg[:, -2].abs().max().item() == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("lp,d,lq,nq", [
    (1, 128, 32, 9), (63, 80, 1, 300), (64, 16, 129, 3), (65, 144, 256, 5),
    (767, 256, 32, 17), (768, 128, 32, 256), (768, 80, 257, 3),
    (65, 256, 1, 257), (767, 144, 129, 4), (64, 128, 256, 2)])
def test_k1_bf16_wgmma_kernel_matches_plain_version_on_the_card(lp, d, lq,
                                                                nq):
    """K1 bf16 (wgmma on TMA-loaded tiles) against its plain version where
    the tensor maps and the stage ring can go wrong: Lp around the 64- and
    128-token tiles (the last doc's ragged tail read past the page
    tensor's end, zero-filled by TMA, and a doc's tail beside the next
    doc's tokens), D on either side of the rule by D (16, 80 with a
    zero-filled box, 128, 144 and 256), Lq 1 to 256 in one launch and 257
    in two, nq off the query block, a doc with no valid token (scores 0).
    Summation order alone differs: 1e-4 on sums of <= 257 unit-bounded
    terms. The configuration the rule picks fits the card's 232,448 bytes
    of shared memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.set_float32_matmul_precision("highest")
    cm = cuda_maxsim
    rng = np.random.default_rng(lp + d + lq + nq)
    dev, nd = "cuda", 23

    def unit(*shape):
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        return (x / x.norm(dim=-1, keepdim=True)).to(dev)

    Q, P = unit(nq, lq, d), unit(nd, lp, d).to(torch.bfloat16)
    qm = torch.from_numpy(rng.random((nq, lq)) > 0.2).to(dev)
    pm = torch.from_numpy(rng.random((nd, lp)) > 0.2).to(dev)
    qm[:, 0] = True
    pm[nd // 2] = False
    pm[-1, -1] = True  # the last token of the tensor is valid
    cfg = cm.bf16_config(d)
    assert cfg["smem_bytes"] <= 232448 and cfg["ctas_per_sm"] >= 1
    assert cfg["rows"] == cm.ROW_CAP["maxsim_bf16"]
    assert cfg["tile_tokens"] == (128 if d <= 192 else 64)
    n0 = cm.launch_counts()["maxsim_cuda"]
    got = cm.maxsim_cuda(Q, P, qm, pm)
    torch.cuda.synchronize()
    assert cm.launch_counts()["maxsim_cuda"] == n0 + -(-lq // 256)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, cm.maxsim_plain(Q, P, qm, pm), rtol=0,
                               atol=1e-4)
    assert got[:, nd // 2].abs().max().item() == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("n_blocks,lq,d,lp", [
    (1, 32, 128, 77), (2, 32, 128, 64), (3, 128, 48, 65), (5, 32, 48, 129),
    (9, 7, 64, 33), (17, 32, 128, 767)])
def test_pq_kernel_clusters_match_plain_versions_on_the_card(n_blocks, lq, d,
                                                             lp):
    """K3 (pq and pqfull; compact books in shared memory, compact books of
    2-byte subvectors and expanded books, both through the L2 sum decode)
    at 1, 2, 3, 5, 9 and 17 query blocks (clusters of 1, 2, 2, 4, 8 and 8
    CTAs with full-width books, of 1 or 2 with compact ones; the last
    cluster partly padding), Lq 128, odd Lp, M = 12 at D =
    48, with a doc that has no valid token, against the plain versions
    (summation order alone differs: 1e-4, 1e-5 relative). A call on the
    first query block alone (a cluster of one) gives the same scores bit
    for bit: the split of the decode between CTAs changes no value."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.set_float32_matmul_precision("highest")
    cm = cuda_maxsim
    rng = np.random.default_rng(n_blocks + lq + d + lp)
    dev = "cuda"
    qb = 128 // lq
    nq, nd = n_blocks * qb - (1 if qb > 1 else 0), 9

    def unit(*shape):
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        return (x / x.norm(dim=-1, keepdim=True)).to(dev)

    Q = unit(nq, lq, d)
    qm = torch.from_numpy(rng.random((nq, lq)) > 0.2).to(dev)
    pm = torch.from_numpy(rng.random((nd, lp)) > 0.2).to(dev)
    pm[nd // 2] = False
    m = 12 if d == 48 else 16
    books = {"compact": unit(m, 256, d // m) * 0.5,
             "compact2": unit(d // 2, 200, 2) * 0.5,
             "expanded": unit(4, 40, d) * 0.5}
    top = 1 << (n_blocks.bit_length() - 1)
    assert cm.pq_cluster(nq, lq) == min(8, top)
    assert cm.pq_cluster(nq, lq, compact=True) == min(
        cm.MAX_CLUSTER["compact"], top)
    for name, b in books.items():
        top = min(b.shape[1], 256)
        codes = torch.from_numpy(rng.integers(0, top, (nd, lp, b.shape[0]),
                                              np.uint8)).to(dev)
        for kern, plain in ((cm.maxsim_cuda_pq, cm.maxsim_pq_plain),
                            (cm.maxsim_cuda_pqfull, cm.maxsim_pqfull_plain)):
            n0 = cm.launch_counts()[kern.__name__]
            got = kern(Q, codes, qm, pm, b)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, plain(Q, codes, qm, pm, b),
                                       rtol=1e-5, atol=1e-4)
            assert got[:, nd // 2].abs().max().item() == 0.0, name
            assert cm.launch_counts()[kern.__name__] == n0 + 1
            one = kern(Q[:qb], codes, qm[:qb], pm, b)
            assert torch.equal(one, got[:qb]), (name, kern.__name__)


@pytest.mark.gpu
@pytest.mark.parametrize("lq", [32, 14])
@pytest.mark.parametrize("lp,d", [(1, 16), (137, 128), (154, 96),
                                  (767, 192), (137, 32), (64, 64),
                                  (767, 128)])
def test_f32_kernel_matches_plain_version_and_k5_on_the_card(lp, d, lq):
    """K1 in float32 mode at Lp 1, 137, 154 and 767 and D 16-192 (several
    query blocks, a partial last one, a doc with no valid token; both of
    its tile configurations: 128 x 32 at D = 192, 256 x 64 at D <= 128), at
    Lq 32 and at the teacher precompute's Lq 14, which does not divide the
    tile's rows (18 queries a block, 4 rows empty): within 1e-4 of its
    plain version (3xTF32 against full f32 products, summation order), and
    bit-equal to K5 float32's scores (the same three products per k-step
    in the same order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.set_float32_matmul_precision("highest")
    rng = np.random.default_rng(lp + d + lq)
    nq, nd = 41, 13
    Q = torch.from_numpy(rng.normal(size=(nq, lq, d)).astype(np.float32))
    Q = (Q / Q.norm(dim=-1, keepdim=True)).to("cuda")
    P = torch.from_numpy(rng.normal(size=(nd, lp, d)).astype(np.float32))
    P = (P / P.norm(dim=-1, keepdim=True)).to("cuda")
    qm = torch.from_numpy(rng.random((nq, lq)) > 0.2).to("cuda")
    pm = torch.from_numpy(rng.random((nd, lp)) > 0.2).to("cuda")
    pm[:, 0] = True
    pm[nd // 2] = False
    n0 = cuda_maxsim.launch_counts()["maxsim_cuda_f32"]
    got = cuda_maxsim.maxsim_cuda_f32(Q, P, qm, pm)
    torch.cuda.synchronize()
    assert cuda_maxsim.launch_counts()["maxsim_cuda_f32"] == n0 + 1
    torch.testing.assert_close(
        got, cuda_maxsim.maxsim_plain(Q, P, qm, pm, compute=torch.float32),
        rtol=0, atol=1e-4)
    assert got[:, nd // 2].abs().max().item() == 0.0
    out, _ = cuda_maxsim_train.maxsim_cuda_fwd_train_f32(Q, P, qm, pm)
    assert torch.equal(got, out)
    per_sm, rows, cols = cuda_maxsim.f32_occupancy(d)
    assert (rows, cols, per_sm) == ((128, 32, 1) if d > 128 else (256, 64, 1))


@pytest.mark.gpu
@pytest.mark.parametrize("lq,d", [(129, 40), (200, 72), (129, 72),
                                  (200, 40), (200, 128), (129, 264),
                                  (200, 320), (40, 512)])
def test_every_wrapper_serves_any_lq_and_d_on_the_card(lq, d):
    """Queries longer than a kernel's query-token rows (sliced, one launch
    a slice, the partial scores added), D off the kernels' granule
    (zero-padded) and D above the fast kernels' bound (264, 320, 512: the
    wide functions, float32 from 208): every forward wrapper (K1 bf16 and
    float32, K2, K2b, K3 with compact and expanded books, K4) against its
    plain version on the card, and MaxSimFn (K5, then K6 per slice; the
    wide K6 in one launch) in bf16 and float32 against
    the plain K5/K6 pair, on tie-free data, with a doc that has no valid
    token. Summation order alone differs: scores within 1e-5 relative and
    1e-4 (sums of <= 200 unit-bounded terms); K6's dQ and dP within 1e-3
    (bf16) and 1e-4 (float32) relative, Frobenius."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from evdr_tpu_torch.ops.int4 import quantize_tokens_int4
    from evdr_tpu_torch.ops.quantize import quantize_tokens_int8

    torch.set_float32_matmul_precision("highest")
    cm, ct = cuda_maxsim, cuda_maxsim_train
    rng = np.random.default_rng(lq + d)
    nq, nd, lp, dev = 5, 9, 71, "cuda"

    def unit(*shape):
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        return (x / x.norm(dim=-1, keepdim=True)).to(dev)

    Q, P = unit(nq, lq, d), unit(nd, lp, d)
    qm = torch.from_numpy(rng.random((nq, lq)) > 0.2).to(dev)
    pm = torch.from_numpy(rng.random((nd, lp)) > 0.2).to(dev)
    qm[:, 0] = True
    pm[nd // 2] = False
    codes, sc = quantize_tokens_int8(P, pm)
    packed, sc4 = quantize_tokens_int4(P, pm)
    i8, i4 = (Q, codes, sc, qm, pm), (Q, packed, sc4, qm, pm)
    compact, expanded = unit(d // 8, 200, 8) * 0.5, unit(4, 40, d) * 0.3
    pq_codes = torch.from_numpy(
        rng.integers(0, 40, (nd, lp, d // 8), np.uint8)).to(dev)
    cases = [  # (wrapper, plain version, args, library)
        (cm.maxsim_cuda, cm.maxsim_plain, (Q, P.to(torch.bfloat16), qm, pm),
         "maxsim_bf16"),
        (cm.maxsim_cuda_f32,
         lambda *a: cm.maxsim_plain(*a, compute=torch.float32),
         (Q, P, qm, pm), "maxsim_f32"),
        (cm.maxsim_cuda_int8, cm.maxsim_int8_plain, i8, "maxsim_int8"),
        (cm.maxsim_cuda_int8full, cm.maxsim_int8full_plain, i8,
         "maxsim_int8"),
        (cm.maxsim_cuda_int8_deferred, cm.maxsim_int8_plain, i8,
         "maxsim_int8_defer"),
        (cm.maxsim_cuda_int8full_deferred, cm.maxsim_int8full_plain, i8,
         "maxsim_int8_defer"),
        (cm.maxsim_cuda_int4, cm.maxsim_int4_plain, i4, "maxsim_int4"),
        (cm.maxsim_cuda_int4full, cm.maxsim_int4full_plain, i4,
         "maxsim_int4"),
        (cm.maxsim_cuda_pq, cm.maxsim_pq_plain,
         (Q, pq_codes, qm, pm, compact), "maxsim_pq"),
        (cm.maxsim_cuda_pqfull, cm.maxsim_pqfull_plain,
         (Q, pq_codes, qm, pm, compact), "maxsim_pq"),
        (cm.maxsim_cuda_pq, cm.maxsim_pq_plain,
         (Q, pq_codes[..., :4].contiguous(), qm, pm, expanded), "maxsim_pq")]
    for kern, plain, args, lib in cases:
        n0 = cm.launch_counts()[kern.__name__]
        got = kern(*args)
        torch.cuda.synchronize()
        assert (cm.launch_counts()[kern.__name__]
                == n0 + -(-lq // cm.row_cap(lib, cm.kernel_dim(d))))
        torch.testing.assert_close(got, plain(*args), rtol=1e-5, atol=1e-4,
                                   msg=kern.__name__)
        assert got[:, nd // 2].abs().max().item() == 0.0
    g = torch.from_numpy(rng.normal(size=(nq, nd)).astype(np.float32)).to(dev)
    for cd, rel in ((torch.bfloat16, 1e-3), (torch.float32, 1e-4)):
        pmu = pm.clone()
        _untie(Q, qm, P, pmu, dtype=cd)
        Qg, Pg = Q.clone().requires_grad_(True), P.clone().requires_grad_(True)
        out = ct.MaxSimFn.apply(Qg, Pg, qm, pmu, cd)
        out.backward(g)
        out_p, M_p = ct.maxsim_fwd_train_plain(Q, P, qm, pmu, cd)
        dq_p, dp_p = ct.maxsim_bwd_plain(Q, P, qm, pmu, M_p, g, cd)
        torch.testing.assert_close(out.detach(), out_p, rtol=1e-5, atol=1e-4)
        for a, b in ((Qg.grad, dq_p), (Pg.grad, dp_p)):
            assert a.shape == b.shape
            assert float((a - b).norm() / b.norm()) <= rel


@pytest.mark.gpu
@pytest.mark.parametrize("cd", ["bfloat16", "float32"])
@pytest.mark.parametrize("nq,lq,nd,lp,d,zeros", [
    (4, 32, 40, 154, 128, 1),   # 1 query block: a cluster of one
    (12, 32, 37, 70, 32, 1),    # 3 blocks: a cluster of 4, one padding CTA
    (32, 32, 300, 154, 96, 1),  # 8 blocks: one full cluster
    (36, 32, 23, 65, 192, 1),   # 9 blocks: two chunks, 8 + a cluster of one
    (20, 7, 17, 63, 256, 1),    # Lq 7, 2 blocks; float32: the wide K6
    (16, 32, 20, 70, 64, 32),   # a zero query: more hits than a pull lists
    (10, 32, 24, 154, 320, 1),  # D 320: the wide K5 and K6 in both modes
])
def test_k6_sparse_cluster_kernel_matches_plain_version_on_the_card(
        nq, lq, nd, lp, d, zeros, cd):
    """K6 in both modes against its plain version: D 32 to 320 (above 256,
    float32 above 192, the wide K6 on the wide K5's M, one launch for every
    query token), 1, 2, 3, 4, 8 and 9 query
    blocks, Lp off a multiple of 64, a doc with no valid token, qmask-0
    rows, and exact ties planted after the data is made tie-free (a page
    token duplicated inside its doc; the first ``zeros`` tokens of the last
    query zero with qmask 1, each tying with every valid token: 32 of them
    give a tile's tokens more hits than the dP pull's list holds, which it
    then takes one at a time). Summation order alone differs: dQ and dP
    within 1e-3 (bf16) and 1e-4 (float32) relative, Frobenius; both tied
    tokens get the same gradient. Two calls give the same bits, and K6
    launches once per chunk of MAX_QB_BLOCKS query blocks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cd = getattr(torch, cd)
    ct = cuda_maxsim_train
    wide = d > (cuda_maxsim.F32_MAX_D if cd == torch.float32
                else cuda_maxsim.MAX_D)
    torch.set_float32_matmul_precision("highest")
    rng = np.random.default_rng(nq + lq + d)
    dev = "cuda"

    def unit(*shape):
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        return (x / x.norm(dim=-1, keepdim=True)).to(dev)

    Q, P = unit(nq, lq, d), unit(nd, lp, d)
    qm = torch.from_numpy(rng.random((nq, lq)) > 0.2).to(dev)
    pm = torch.from_numpy(rng.random((nd, lp)) > 0.2).to(dev)
    qm[:, 0] = True
    pm[:, 0] = True
    pm[nd // 2] = False
    Q[0, 0] = P[1, 0]  # query 0's first token points at doc 1's token 0
    _untie(Q, qm, P, pm, dtype=cd)
    # ties: doc 1 holds its token 0 twice; the last query's first token is
    # zero (all its valid tokens tie)
    P[1, lp - 1] = P[1, 0]
    pm[1, 0] = pm[1, lp - 1] = True
    Q[-1, :zeros] = 0.0
    qm[-1, :zeros] = True
    g = torch.from_numpy(rng.normal(size=(nq, nd)).astype(np.float32)).to(dev)
    name = "maxsim_cuda_bwd_f32" if cd == torch.float32 else "maxsim_cuda_bwd"
    _, M = ct.maxsim_cuda_fwd_train(Q, P, qm, pm, cd)
    _, M_p = ct.maxsim_fwd_train_plain(Q, P, qm, pm, cd)
    n0 = cuda_maxsim.launch_counts()[name]
    dq, dp = ct.maxsim_cuda_bwd(Q, P, qm, pm, M, g, cd)
    dq2, dp2 = ct.maxsim_cuda_bwd(Q, P, qm, pm, M, g, cd)
    torch.cuda.synchronize()
    n_qb = -(-nq // (128 // lq))
    assert (cuda_maxsim.launch_counts()[name]
            == n0 + 2 * (1 if wide else -(-n_qb // ct.MAX_QB_BLOCKS)))
    assert torch.equal(dq, dq2) and torch.equal(dp, dp2)
    dq_p, dp_p = ct.maxsim_bwd_plain(Q, P, qm, pm, M_p, g, cd)
    rel = 1e-4 if cd == torch.float32 else 1e-3
    for a, b in ((dq, dq_p), (dp, dp_p)):
        assert torch.isfinite(a).all()
        assert float((a - b).norm() / b.norm()) <= rel
    assert torch.equal(dp[1, 0], dp[1, lp - 1])
    assert float(dp[nd // 2].abs().max()) == 0.0
    # the zero row's gradient: every valid token of every doc that has one
    has = pm.any(dim=1)
    w = g[-1] * has
    e = w if cd == torch.float32 else w.to(torch.bfloat16).float()
    want = (e[:, None, None] * pm[..., None] * P.to(cd).float()).sum((0, 1))
    torch.testing.assert_close(dq[-1, 0], want, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("cd", ["bfloat16", "float32"])
@pytest.mark.parametrize("nq,lq,nd,lp,d", [
    (32, 32, 200, 137, 128),  # the train step's queries, mf5 pages
    (36, 32, 60, 154, 96),    # 9 K6 query blocks: two chunks
    (5, 200, 30, 77, 64),     # odd Lp; Lq 200: one K5 launch, two K6 slices
    (12, 20, 40, 137, 192),   # D 192: float32's narrow tile, K6 at 2 stages
    (6, 16, 25, 154, 256),    # D 256 (float32: the wide loop)
    (3, 7, 9, 1, 32),         # Lp 1: a doc ends every tile
    (9, 32, 20, 137, 320),    # D 320: the wide K5 and K6 in both modes
])
def test_k5_is_k1_with_an_m_store_and_k6_follows_it_on_the_card(
        nq, lq, nd, lp, d, cd):
    """K5 in both modes is K1's kernel with an M store: its scores equal
    K1's on the same inputs bit for bit (the same kernel, tiles and
    slices), and with M lie within 1e-4 of the plain version (summation
    order); its launches take K1's row cap. K6 on K5's M against the plain
    pair within 1e-3 (bf16) and 1e-4 (float32) relative, Frobenius, with
    exact ties planted after the data is made tie-free (a page token
    duplicated in its doc, a zero query token with qmask 1), at the mf5
    student's Lp 137 and 154, odd Lp 77, Lp 1, D 32 to 320 (above 256,
    float32 above 192: the wide K5, K1's wide loop with the M store, and
    the wide K6) and 1 to 9 query blocks; two calls of K6 give the same
    bits. K5 bf16 runs 64-token tiles, the width K6 recomputes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cd = getattr(torch, cd)
    cm, ct = cuda_maxsim, cuda_maxsim_train
    wide = d > (cm.F32_MAX_D if cd == torch.float32 else cm.MAX_D)
    torch.set_float32_matmul_precision("highest")
    rng = np.random.default_rng(nq + lq + lp + d)
    dev = "cuda"

    def unit(*shape):
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        return (x / x.norm(dim=-1, keepdim=True)).to(dev)

    Q, P = unit(nq, lq, d), unit(nd, lp, d)
    qm = torch.from_numpy(rng.random((nq, lq)) > 0.2).to(dev)
    pm = torch.from_numpy(rng.random((nd, lp)) > 0.2).to(dev)
    qm[:, 0] = True
    pm[:, 0] = True
    pm[nd // 2] = False
    _untie(Q, qm, P, pm, dtype=cd)
    if lp > 1:
        P[1, lp - 1] = P[1, 0]
        pm[1, lp - 1] = True
    Q[-1, 0] = 0.0
    qm[-1, 0] = True
    g = torch.from_numpy(rng.normal(size=(nq, nd)).astype(np.float32)).to(dev)
    lib, fwd = (("maxsim_f32", "maxsim_cuda_fwd_train_f32")
                if cd == torch.float32
                else ("maxsim_bf16", "maxsim_cuda_fwd_train"))
    n0 = cm.launch_counts()[fwd]
    out, M = ct.maxsim_cuda_fwd_train(Q, P, qm, pm, cd)
    torch.cuda.synchronize()
    assert (cm.launch_counts()[fwd]
            == n0 + -(-lq // cm.row_cap(lib, cm.kernel_dim(d))))
    assert torch.equal(out, cm.maxsim_cuda(Q, P, qm, pm, cd))
    out_p, M_p = ct.maxsim_fwd_train_plain(Q, P, qm, pm, cd)
    torch.testing.assert_close(out, out_p, rtol=0, atol=1e-4)
    torch.testing.assert_close(M, M_p, rtol=0, atol=1e-4)
    assert float(out[:, nd // 2].abs().max()) == 0.0
    dq, dp = ct.maxsim_cuda_bwd(Q, P, qm, pm, M, g, cd)
    dq2, dp2 = ct.maxsim_cuda_bwd(Q, P, qm, pm, M, g, cd)
    assert torch.equal(dq, dq2) and torch.equal(dp, dp2)
    dq_p, dp_p = ct.maxsim_bwd_plain(Q, P, qm, pm, M_p, g, cd)
    rel = 1e-4 if cd == torch.float32 else 1e-3
    for a, b in ((dq, dq_p), (dp, dp_p)):
        assert torch.isfinite(a).all()
        assert float((a - b).norm() / b.norm()) <= rel
    if lp > 1:
        assert torch.equal(dp[1, 0], dp[1, lp - 1])
    assert float(dp[nd // 2].abs().max()) == 0.0
    if wide:
        assert cm.launch_shapes[(fwd, ("evdr_maxsim_fwd_train_f32_wide"
                                       if cd == torch.float32 else
                                       "evdr_maxsim_fwd_train_wide"),
                                 nq, lq, nd, lp)] > 0
    elif cd == torch.bfloat16:
        cfg = cm.bf16_config(cm.kernel_dim(d), train=True)
        assert (cfg["rows"], cfg["tile_tokens"]) == (256, 64)
    else:
        rows = cm.f32_occupancy(cm.kernel_dim(d), train=True)[1]
        assert rows == cm.row_cap(lib, cm.kernel_dim(d))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,q8,sdtype,func", [
    ("int8", False, None, "evdr_maxsim_int8"),
    ("int8", True, None, "evdr_maxsim_int8full"),
    ("int8", False, "int4", "evdr_maxsim_int4"),
    ("bfloat16", False, None, "evdr_maxsim_bf16"),
    ("pq", False, None, "evdr_maxsim_bf16")])
def test_pruned_engine_equals_exact_search_at_full_cover_on_the_card(
        dtype, q8, sdtype, func):
    """A pruned engine on the card: stage 1 scores the summary index (4
    centres a page) through the serving kernel of its tier at Lp 4, stage
    2 reranks in f32. At n_candidates = n_docs the top-10 equals exact f32
    MaxSim over the stored index (dequantized, or PQ decoded from its f32
    books) at every rank untied by more than 1e-3 (summation order alone),
    the returned scores equal it (1e-3), and no index reaches n_docs, a
    doc with no valid token included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from evdr_tpu_torch.ops.maxsim import maxsim_torch
    from evdr_tpu_torch.ops.pruned import _decode_pq
    from evdr_tpu_torch.parallel.topk import _select_topk

    torch.set_float32_matmul_precision("highest")
    cm = cuda_maxsim
    rng = np.random.default_rng(len(func) + q8)
    nd, lp, d, nq, lq, k = 300, 70, 128, 12, 16, 10
    P = rng.normal(size=(nd, lp, d)).astype(np.float32)
    pm = rng.random((nd, lp)) > 0.1
    pm[5] = False
    Q = rng.normal(size=(nq, lq, d)).astype(np.float32)
    Q /= np.linalg.norm(Q, axis=-1, keepdims=True)
    qm = np.ones((nq, lq), bool)
    eng = RetrievalEngine(dtype=dtype, quantize_queries=q8, pq_m=16,
                          prune_centroids=4, summary_dtype=sdtype).build(
        P, pm)
    cm.reset_launch_counts()
    vals, idx = eng.search_dense(Q, qm, k=k, n_candidates=nd)
    assert cm.func_launches(func) == 1
    assert cm.func_launches("evdr_maxsim_int8full_wg") == 0  # Lp 4
    assert all(s[5] == 4 for s in cm.launch_shapes)
    assert idx.max() < nd and 5 not in idx[:, :-1]
    ix = eng.index
    T = ix.P[:nd]
    if ix.books is not None:
        T = _decode_pq(T, ix.books, d, "take")
    elif T.dtype == torch.uint8:
        T = cm.unpack_int4_torch(T, lp)
    T = T.float()
    if ix.scales is not None:
        T = T * ix.scales[:nd][..., None]
    Qd = torch.from_numpy(Q).cuda()
    sc = maxsim_torch(Qd, T, torch.from_numpy(qm).cuda(), ix.pmask[:nd])
    sc[:, 5] = -torch.inf  # the rerank ranks an empty doc last
    ve, ie = (x.cpu().numpy() for x in _select_topk(sc, k + 1))
    np.testing.assert_allclose(vals[:, :9], ve[:, :9], rtol=0, atol=1e-3)
    step = ve[:, :-1] - ve[:, 1:]
    above = np.concatenate([np.full((nq, 1), np.inf), step], axis=1)
    untied = (above[:, :k] > 1e-3) & (step[:, :k] > 1e-3)
    assert untied.sum() > nq and (ie[:, :k][untied] == idx[untied]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("tier", ["int8", "int4", "queries", "books"])
def test_device_token_quantizers_equal_host_on_the_card(tier):
    """The int8 and int4 token quantizers, the int8 query quantizer and the
    int8 PQ book quantizer give the host's codes and scales bit for bit on
    the card, so an index quantized there (a tail, a streamed chunk, a
    tensor build) equals one quantized from numpy, and queries quantized
    there equal the benchmark reference's (a true division)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from evdr_tpu_torch.ops.int4 import quantize_tokens_int4
    from evdr_tpu_torch.ops.quantize import quantize_tokens_int8

    quantize = {"int8": quantize_tokens_int8, "int4": quantize_tokens_int4,
                "queries": cuda_maxsim.quantize_queries_int8,
                "books": lambda B, _: cuda_maxsim.quantize_books_int8(B)}[tier]
    rng = np.random.default_rng(7)
    P = rng.normal(size=(64, 37, 128)).astype(np.float32)
    P /= np.linalg.norm(P, axis=-1, keepdims=True)
    pm = rng.random((64, 37)) > 0.1
    if tier in ("queries", "books"):
        P *= rng.uniform(1e-3, 1e3, size=(64, 37, 1)).astype(np.float32)
        codes, scales = (t.numpy() for t in quantize(
            torch.from_numpy(P), torch.from_numpy(pm)))
    else:
        codes, scales = quantize(P, pm)
    dc, ds = quantize(torch.from_numpy(P).cuda(), torch.from_numpy(pm).cuda())
    np.testing.assert_array_equal(dc.cpu().numpy(), codes)
    np.testing.assert_array_equal(ds.cpu().numpy(), scales)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["int8", "int4", "bfloat16"])
def test_block_build_and_mesh_search_never_sync_the_host_on_the_cards(
        dtype, monkeypatch):
    """A 4-shard mesh (over four cards where the machine has them, else on
    cuda:0): ``build_blocks`` from blocks already on each shard's card
    equals ``build`` of the whole host array bit for bit, and neither the
    block build nor a mesh search's own work (queries out, each shard's
    kernel and local top-k, the merge) syncs the host, so the cards work
    at once (``torch.cuda.set_sync_debug_mode('error')`` raises on a
    sync)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from evdr_tpu_torch.parallel import sharded_index, topk
    from evdr_tpu_torch.parallel.mesh import mesh_of

    monkeypatch.setattr(sharded_index, "BLOCK_ROWS", 100)
    n_cards = torch.cuda.device_count()
    devs = ([f"cuda:{i}" for i in range(4)] if n_cards >= 4
            else ["cuda:0"] * 4)
    rng = np.random.default_rng(11)
    nd, lp, d, nq, lq, k = 700, 64, 128, 16, 32, 10
    P = rng.normal(size=(nd, lp, d)).astype(np.float32)
    P /= np.linalg.norm(P, axis=-1, keepdims=True)
    pm = rng.random((nd, lp)) > 0.1
    P *= pm[..., None]
    on = {torch.device(x): (torch.as_tensor(P, device=x),
                            torch.as_tensor(pm, device=x)) for x in devs}
    Q = rng.normal(size=(nq, lq, d)).astype(np.float32)
    Q /= np.linalg.norm(Q, axis=-1, keepdims=True)
    qm = np.ones((nq, lq), bool)
    kw = dict(dtype=dtype, quantize_queries=dtype in ("int8", "int4"),
              normalize=False, mesh=mesh_of(devs))
    whole = RetrievalEngine(**kw).build(P, pm)
    Qd = torch.as_tensor(Q, device=devs[0])
    qmd = torch.as_tensor(qm, device=devs[0])
    torch.cuda.synchronize()
    blk = RetrievalEngine(**kw)
    torch.cuda.set_sync_debug_mode("error")
    try:
        blk.build_blocks(lambda lo, hi, dev: (on[dev][0][lo:hi],
                                              on[dev][1][lo:hi]), nd)
        vals, ids = topk.sharded_topk(Qd, qmd, blk.index, k, blk.impl)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for a, b in zip(blk.index.parts, whole.index.parts, strict=True):
        assert a.P.device == b.P.device
        assert torch.equal(a.P.view(torch.int8), b.P.view(torch.int8))
        assert torch.equal(a.pmask, b.pmask)
        assert (a.scales is None) == (b.scales is None)
        assert a.scales is None or torch.equal(a.scales, b.scales)
    want = whole.search_dense(Q, qm, k=k)
    np.testing.assert_array_equal(ids.cpu().numpy(), want[1])
    np.testing.assert_array_equal(vals.cpu().numpy(), want[0])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,q8,func", [
    ("bfloat16", False, "evdr_maxsim_bf16"),
    ("int8", False, "evdr_maxsim_int8"),
    ("int8", True, "evdr_maxsim_int8full_wg"),
    ("int4", False, "evdr_maxsim_int4"),
    ("pq", False, "evdr_maxsim_pq")])
def test_incremental_engine_on_the_card(dtype, q8, func, tmp_path):
    """Incremental serving on the card: two adds (Lp 70 and 63, one
    upsert), deletes in main and tail; the merged search launches the
    tier's kernel once on the main index and once on the tail, returns no
    deleted doc, and (but for pq, whose codes depend on the books) gives
    the ids and scores of a fresh engine on the live corpus bit for bit
    (the tail quantizes on the card, the fresh build from numpy on the
    host: their scales agree); compact and a save -> from_npz(mmap=True)
    round trip keep the ids and scores bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cm = cuda_maxsim
    rng = np.random.default_rng(len(func) + q8)
    nd, lp, d, nq, lq, k = 300, 70, 128, 12, 16, 10

    def pages(n, lp_):
        P = rng.normal(size=(n, lp_, d)).astype(np.float32)
        return P, rng.random((n, lp_)) > 0.1

    P, pm = pages(nd, lp)
    A, am = pages(40, lp)
    B, bm = pages(30, lp - 7)
    Q = rng.normal(size=(nq, lq, d)).astype(np.float32)
    Q /= np.linalg.norm(Q, axis=-1, keepdims=True)
    qm = np.ones((nq, lq), bool)
    kw = dict(dtype=dtype, quantize_queries=q8, pq_m=16)
    eng = RetrievalEngine(**kw).build(P, pm,
                                      docids=[f"m{i}" for i in range(nd)])
    eng.add(A, am, docids=[f"a{i}" for i in range(40)])
    eng.add(B, bm, docids=["m7"] + [f"b{i}" for i in range(1, 30)])
    dead = ["m3", "m100", "a5", "b9"]
    assert eng.delete(dead) == 4 and eng.n_docs == nd + 70 - 5
    cm.reset_launch_counts()
    vals, idx = eng.search_dense(Q, qm, k=k)
    assert cm.func_launches(func) == 2
    ids = eng.ids_for(idx)
    assert not set(dead) & {x for row in ids for x in row}
    assert not np.isin(idx, [3, 7, 100, nd + 5, nd + 49]).any()
    if dtype != "pq":
        Bp = np.pad(B, ((0, 0), (0, 7), (0, 0)))
        bmp = np.pad(bm, ((0, 0), (0, 7)))
        keep = [i for i in range(nd) if i not in (3, 7, 100)]
        live_a = [i for i in range(40) if i != 5]
        live_b = [i for i in range(30) if i != 9]
        fresh = RetrievalEngine(**kw).build(
            np.concatenate([P[keep], A[live_a], Bp[live_b]]),
            np.concatenate([pm[keep], am[live_a], bmp[live_b]]),
            docids=[f"m{i}" for i in keep] + [f"a{i}" for i in live_a]
            + ["m7" if i == 0 else f"b{i}" for i in live_b])
        fv, fi = fresh.search_dense(Q, qm, k=k)
        assert fresh.ids_for(fi) == ids
        np.testing.assert_array_equal(fv, vals)
    eng.compact()
    v2, i2 = eng.search_dense(Q, qm, k=k)
    assert eng.ids_for(i2) == ids
    np.testing.assert_array_equal(v2, vals)
    eng.save_npz(tmp_path / "s.npz")
    e3 = RetrievalEngine.from_npz(tmp_path / "s.npz", mmap=True, **kw)
    v3, i3 = e3.search_dense(Q, qm, k=k)
    assert e3.ids_for(i3) == ids
    np.testing.assert_array_equal(v3, v2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,q8,func", [
    ("bfloat16", False, "evdr_maxsim_bf16"),
    ("int8", False, "evdr_maxsim_int8"),
    ("int8", True, "evdr_maxsim_int8full_wg"),
    ("int4", False, "evdr_maxsim_int4"),
    ("pq", False, "evdr_maxsim_pq")])
def test_four_shard_mesh_on_one_card_equals_one_shard_engine(dtype, q8,
                                                              func):
    """A 4-shard mesh on cuda:0 (four shards on one card) launches the
    tier's kernel once a shard and returns the one-shard engine's ids and
    scores bit for bit (a doc's score does not depend on the launch's doc
    count), exact and pruned, and after an add and a delete."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from evdr_tpu_torch.parallel.mesh import mesh_of

    cm = cuda_maxsim
    rng = np.random.default_rng(len(func) + q8)
    nd, lp, d, nq, lq, k = 500, 70, 128, 12, 16, 10
    P = rng.normal(size=(nd, lp, d)).astype(np.float32)
    pm = rng.random((nd, lp)) > 0.1
    pm[5] = False
    P[256], pm[256] = P[255], pm[255]          # a tie across shards 1, 2
    Q = rng.normal(size=(nq, lq, d)).astype(np.float32)
    Q /= np.linalg.norm(Q, axis=-1, keepdims=True)
    qm = np.ones((nq, lq), bool)
    kw = dict(dtype=dtype, quantize_queries=q8, pq_m=16)
    one = RetrievalEngine(**kw).build(P, pm)
    mesh = RetrievalEngine(mesh=mesh_of(["cuda:0"] * 4), **kw)
    if dtype == "pq":
        mesh.build_from_pq(one.index.P[:nd], one._true_books(), pm)
    else:
        mesh.build(P, pm)
    cm.reset_launch_counts()
    got = mesh.search_dense(Q, qm, k=k)
    assert cm.func_launches(func) == 4
    want = one.search_dense(Q, qm, k=k)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for e in (one, mesh):
        e.add(P[:20] * 0.5, pm[:20], docids=[f"n{i}" for i in range(20)])
        e.delete(["3", "n4", "300"])
    for a, b in zip(mesh.search_dense(Q, qm, k=k),
                    one.search_dense(Q, qm, k=k)):
        np.testing.assert_array_equal(a, b)
