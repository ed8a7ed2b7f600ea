"""The torch port's numpy tools (``evdr_tpu_torch/tools/{split_data,
doc_unique,make_questions,report,xlsx,pool_index,eval_run}.py``) and
``utils/timing.py`` against the JAX package's, on the same inputs.

Each tool runs in both packages; where the output is deterministic the two
outputs must be equal (npz arrays and pickled maps key for key, JSON and
CSV byte for byte, xlsx member for member). Mirrors ``tests/test_tools.py``.
"""

import json
import tomllib
import zipfile
from pathlib import Path

import numpy as np
import pytest

from evdr_tpu.data.synthetic import make_synthetic_corpus, save_synthetic_npz
from evdr_tpu.tools import doc_unique as jdu
from evdr_tpu.tools import eval_run as jev
from evdr_tpu.tools import make_questions as jmq
from evdr_tpu.tools import pool_index as jpi
from evdr_tpu.tools import report as jrep
from evdr_tpu.tools import split_data as jsp
from evdr_tpu.tools import xlsx as jxl
from evdr_tpu_torch.tools import doc_unique as tdu
from evdr_tpu_torch.tools import eval_run as tev
from evdr_tpu_torch.tools import make_questions as tmq
from evdr_tpu_torch.tools import pool_index as tpi
from evdr_tpu_torch.tools import report as trep
from evdr_tpu_torch.tools import split_data as tsp
from evdr_tpu_torch.tools import xlsx as txl

ROOT = Path(__file__).resolve().parents[1]


def _same_value(a, b):
    if isinstance(a, np.ndarray) and a.dtype == object:
        if a.shape == ():
            return _same_value(a.item(), b.item())
        return a.shape == b.shape and all(
            _same_value(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b))
    return a == b


def _assert_npz_equal(p, q):
    a, b = np.load(p, allow_pickle=True), np.load(q, allow_pickle=True)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert _same_value(a[k], b[k]), k


def _assert_zip_equal(p, q):
    with zipfile.ZipFile(p) as a, zipfile.ZipFile(q) as b:
        assert a.namelist() == b.namelist()
        for n in a.namelist():
            assert a.read(n) == b.read(n), n


def _corpus_file(tmp_path, name="foo_dump_all.npz", **kw):
    c = make_synthetic_corpus(**kw)
    src = tmp_path / name
    save_synthetic_npz(src, c)
    return c, src


@pytest.mark.parametrize("shuffle", [True, False])
def test_split_equals_jax(tmp_path, shuffle):
    _, src = _corpus_file(tmp_path, n_docs=8, n_queries=20, dim=16, seed=0)
    outs = [mod.split_query_npz(src, tmp_path / tag, test_ratio=0.25,
                                shuffle=shuffle, seed=1)
            for tag, mod in (("j", jsp), ("t", tsp))]
    for a, b in zip(*outs):
        assert Path(a).name == Path(b).name
        _assert_npz_equal(a, b)
    z = np.load(outs[1][1], allow_pickle=True)
    assert len(z["qid"]) == 5 and len(z["docid"]) == 8
    with pytest.raises(ValueError):
        tsp.split_query_npz(src, tmp_path, test_ratio=0.0)


def test_dedup_and_companion_equal_jax(tmp_path):
    c = make_synthetic_corpus(n_docs=6, n_queries=4, dim=8, seed=1)
    dup = np.concatenate([np.arange(6), [1, 3]])
    payload = dict(c)
    for k in ("docid", "documents", "doc_attnmask", "doc_imgmask"):
        payload[k] = c[k][dup]
    src, comp = tmp_path / "full.npz", tmp_path / "companion.npz"
    save_synthetic_npz(src, payload)
    save_synthetic_npz(comp, {k: payload[k] for k in
                              ("docid", "documents", "doc_attnmask",
                               "doc_imgmask")})
    np.testing.assert_array_equal(
        tdu.first_occurrence_keep(["a", "b", "a", "c", "b", "d"]),
        jdu.first_occurrence_keep(["a", "b", "a", "c", "b", "d"]))
    for tag, mod in (("j", jdu), ("t", tdu)):
        keep, ids = mod.dedup_npz(src, tmp_path / f"{tag}_u.npz")
        mod.dedup_companion_npz(comp, tmp_path / f"{tag}_c.npz", keep, ids,
                                n_full=8)
        with pytest.raises(ValueError):
            mod.dedup_companion_npz(comp, tmp_path / f"{tag}_x.npz", keep,
                                    ids, n_full=7)
    _assert_npz_equal(tmp_path / "j_u.npz", tmp_path / "t_u.npz")
    _assert_npz_equal(tmp_path / "j_c.npz", tmp_path / "t_c.npz")
    info = tdu.sanity_check_unique(tmp_path / "t_c.npz")
    assert info == jdu.sanity_check_unique(tmp_path / "j_c.npz")
    assert info["docid"] == info["documents"] == info["map"] == 6


def test_numbered_questions_parse_as_jax():
    text = ("Here are the questions:\n1. What is the revenue in 2023?\n"
            "2) Who authored the report?\nsome noise\n"
            "3. What fraction of the table is blue?\n4. Extra question")
    for nq in (3, 5):
        got = tmq.parse_numbered_questions(text, nq)
        assert got == jmq.parse_numbered_questions(text, nq)
    assert len(tmq.parse_numbered_questions(text, 3)) == 3


def test_fake_generation_and_resume_equal_jax(tmp_path):
    pages = tmp_path / "pages"
    pages.mkdir()
    for i in range(5):
        (pages / f"page_{i}.jpg").write_bytes(b"\xff\xd8fakejpg")
    for tag, mod in (("j", jmq), ("t", tmq)):
        out = tmp_path / f"{tag}.json"
        mod.generate_questions(pages, out, nq=4, backend="fake", save_every=2)
        data = json.loads(out.read_text())
        data["page_2"]["error"] = "boom"
        data["page_2"]["Question"] = []
        out.write_text(json.dumps(data))
        res = mod.generate_questions(pages, out, nq=4, backend="fake")
        assert len(res["page_2"]["Question"]) == 4
        assert "error" not in res["page_2"]
    assert (tmp_path / "j.json").read_bytes() == (tmp_path / "t.json"
                                                  ).read_bytes()


def test_openai_backend_fails_without_its_package(tmp_path, monkeypatch):
    """The openai backend imports its package when it runs: where the
    package is missing (hidden here) every page records the import
    error."""
    import sys

    monkeypatch.setitem(sys.modules, "openai", None)
    pages = tmp_path / "pages"
    pages.mkdir()
    (pages / "p.jpg").write_bytes(b"\xff\xd8")
    res = tmq.generate_questions(pages, tmp_path / "o.json", nq=2,
                                 backend="openai", retries=1)
    assert res["p"]["Question"] == [] and "openai" in res["p"]["error"]


def _fake_train_log(path: Path, ndcg5: float, r1: float):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join([
        '[2026-01-01 00:00:00,000][INFO] {"step": 10, "eval/NDCG@5": 0.1}',
        '[2026-01-01 00:00:01,000][INFO] {"summary/latency": 1.0, '
        '"summary/best_recall": {"step": 5, "Recall@1": %s, "NDCG@5": %s}, '
        '"summary/best_ndcg5": {"step": 7, "Recall@1": %s, "NDCG@5": %s}, '
        '"note": "training finished"}' % (r1, ndcg5, r1, ndcg5)]))


def test_train_log_report_and_xlsx_equal_jax(tmp_path):
    log = tmp_path / "train.log"
    _fake_train_log(log, 0.81309, 0.7)
    got = trep.parse_train_log(log)
    assert got == jrep.parse_train_log(log)
    assert got["N@5"] == pytest.approx(81.309) and got["step"] == 7
    root = tmp_path / "results"
    for setting, mf, ds, n5, r1 in (("expA", 5, "tabfquad", 0.8, 0.7),
                                    ("expA", 5, "docvqa", 0.6, 0.5),
                                    ("expA", 10, "tabfquad", 0.75, 0.65),
                                    ("expB", 5, "tabfquad", 0.9, 0.85)):
        _fake_train_log(root / setting / f"mf{mf}" / ds / "train.log", n5, r1)
    sj = jrep.write_report(root, tmp_path / "j.xlsx")
    st = trep.write_report(root, tmp_path / "t.xlsx")
    assert st == sj and set(st) == {"mf5", "mf10"}
    _assert_zip_equal(tmp_path / "j.xlsx", tmp_path / "t.xlsx")
    for mf in ("mf5", "mf10"):
        assert (tmp_path / f"t.{mf}.csv").read_bytes() == \
            (tmp_path / f"j.{mf}.csv").read_bytes()
    sheets = {"s&1": [["a<b", 1.5], [None, "x\"y"]]}
    jxl.write_xlsx(tmp_path / "je.xlsx", sheets)
    txl.write_xlsx(tmp_path / "te.xlsx", sheets)
    _assert_zip_equal(tmp_path / "je.xlsx", tmp_path / "te.xlsx")
    with zipfile.ZipFile(tmp_path / "te.xlsx") as zf:
        assert "a&lt;b" in zf.read("xl/worksheets/sheet1.xml").decode()
        assert "s&amp;1" in zf.read("xl/workbook.xml").decode()


@pytest.mark.parametrize("method", ["mean", "kmeans"])
def test_pool_index_equals_jax(tmp_path, method):
    c, src = _corpus_file(tmp_path, "dump_all.npz", n_docs=6, n_queries=4,
                          dim=16, seed=2, doc_len_range=(30, 50))
    for tag, mod in (("j", jpi), ("t", tpi)):
        mod.build_pooled_index(src, tmp_path / tag / "mf5" / "x.npz", mf=5,
                               method=method)
    _assert_npz_equal(tmp_path / "j" / "mf5" / "x.npz",
                      tmp_path / "t" / "mf5" / "x.npz")
    z = np.load(tmp_path / "t" / "mf5" / "x.npz", allow_pickle=True)
    for i, d in enumerate(z["documents"]):
        n_valid = int((np.asarray(c["doc_attnmask"][i], bool)
                       & np.asarray(c["doc_imgmask"][i], bool)).sum())
        assert d.shape[0] == max(1, int(round(n_valid / 5)))
    toks = np.ones((10, 8), dtype=np.float32)
    np.testing.assert_array_equal(tpi._kmeans_pool(toks, mf=5),
                                  jpi._kmeans_pool(toks, mf=5))


def test_eval_run_matches_jax_and_direct_metrics(tmp_path, capsys):
    """The port's search CLI writes a TREC run; the port's eval_run scores
    it as the JAX eval_run does, and as the metrics computed directly from
    the scores, with npz qrels (remapped by --queries) and TREC qrels."""
    from evdr_tpu_torch.data.packing import (l2_normalize, preprocess_docs,
                                             preprocess_queries)
    from evdr_tpu_torch.eval.metrics import compute_retrieval_metrics
    from evdr_tpu_torch.ops.maxsim import maxsim_numpy
    from evdr_tpu_torch.tools.search import main as search_main

    c, idx_p = _corpus_file(tmp_path, "efx_dump_all.npz", n_docs=12,
                            n_queries=8, dim=16, seed=21)
    run_p = tmp_path / "run.trec"
    search_main(["--index", str(idx_p), "--queries", str(idx_p), "--k", "12",
                 "--out", str(run_p), "--dtype", "float32", "--device",
                 "cpu"])
    argv = ["--run", str(run_p), "--qrels", str(idx_p), "--queries",
            str(idx_p), "--k", "1", "5"]
    tev.main(argv)
    got = json.loads(capsys.readouterr().out)
    jev.main(argv)
    assert json.loads(capsys.readouterr().out) == got

    P, pmask, _ = preprocess_docs(c["documents"], c["doc_attnmask"],
                                  c["doc_imgmask"])
    Pn = l2_normalize(P * pmask[..., None].astype(np.float32))
    Q, qmask = preprocess_queries(c["query"], c["query_attnmask"])
    sc = maxsim_numpy(Q, Pn, qmask, pmask)
    docids = [str(d) for d in c["docid"]]
    results = {str(c["qsidx_2_query"][qi]): {docids[di]: float(sc[qi, di])
                                             for di in range(12)}
               for qi in range(8)}
    want = compute_retrieval_metrics(c["relevant_docs"], results,
                                     k_values=[1, 5])
    assert want["NDCG"]["NDCG@5"] > 0.5
    assert got["NDCG"]["NDCG@5"] == pytest.approx(want["NDCG"]["NDCG@5"],
                                                  abs=1e-4)
    assert got["Recall"]["Recall@1"] == pytest.approx(
        want["Recall"]["Recall@1"], abs=1e-4)
    assert got["n_queries"] == 8 and got["n_queries_missing_from_run"] == 0

    qr_p = tmp_path / "qrels.txt"
    qid_of = {str(s): str(i) for i, s in zip(c["qid"], c["qsidx_2_query"])}
    with open(qr_p, "w") as fh:
        for q, docs in c["relevant_docs"].items():
            for d, r in docs.items():
                fh.write(f"{qid_of[q]} 0 {d} {r}\n")
    tev.main(["--run", str(run_p), "--qrels", str(qr_p), "--k", "1", "5"])
    got2 = json.loads(capsys.readouterr().out)
    assert got2["NDCG"] == got["NDCG"] and got2["Recall"] == got["Recall"]
    assert tev.read_trec_run(run_p) == jev.read_trec_run(run_p)
    assert tev.read_trec_qrels(qr_p) == jev.read_trec_qrels(qr_p)


def test_timing_helpers(tmp_path, monkeypatch):
    """trace_ctx(None) is a no-op, trace_ctx(dir) writes a Chrome trace of
    what ran inside it; device_memory_report raises without a GPU."""
    import torch

    from evdr_tpu_torch.utils.timing import device_memory_report, trace_ctx

    with trace_ctx(None):
        pass
    with trace_ctx(tmp_path / "tr"):
        torch.ones(8).sum()
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert trace["traceEvents"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_memory_report()


def test_console_scripts_name_the_ported_tools():
    scripts = tomllib.loads((ROOT / "pyproject.toml").read_text())[
        "project"]["scripts"]
    import importlib

    for name in ("report", "split", "dedup", "makeq", "pool", "eval"):
        target = scripts[f"evdr-{name}-torch"]
        mod, fn = target.split(":")
        assert mod.startswith("evdr_tpu_torch.tools.")
        assert callable(getattr(importlib.import_module(mod), fn))
        assert scripts[f"evdr-{name}"] == target.replace("evdr_tpu_torch",
                                                         "evdr_tpu")
