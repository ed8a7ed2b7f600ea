"""The torch port's serving entry points on the CPU: the HTTP server over a
``device='cpu'`` engine and the batch search CLI, against the engine's own
answers and the JAX package's CLI."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from evdr_tpu.data.synthetic import make_synthetic_corpus, save_synthetic_npz
from evdr_tpu.tools.search import run_search as jax_run_search
from evdr_tpu_torch import RetrievalEngine
from evdr_tpu_torch.data.packing import preprocess_queries
from evdr_tpu_torch.tools import search, serve_http


@pytest.fixture(scope="module")
def corpus():
    return make_synthetic_corpus(n_docs=30, n_queries=8, dim=32, seed=21)


@pytest.fixture(scope="module")
def server(corpus):
    c = corpus
    eng = RetrievalEngine(dtype="bfloat16", device="cpu").build_from_ragged(
        c["documents"], c["doc_attnmask"], c["doc_imgmask"],
        docids=c["docid"])
    srv = serve_http.make_server(eng, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield eng, f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    t.join(timeout=10)
    assert not t.is_alive()


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, r.read().decode()


def _post(url, obj):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_healthz_reports_resolved_impl(server):
    eng, url = server
    code, body = _get(url + "/healthz")
    h = json.loads(body)
    assert code == 200 and h["status"] == "ok"
    assert h["n_docs"] == 30 and h["impl"] == "plain" and h["device"] == "cpu"


def test_search_matches_engine_and_metrics_count_it(server, corpus):
    eng, url = server
    qs = [np.asarray(q, np.float32) for q in corpus["query"][:4]]
    code, body = _post(url + "/search",
                       {"queries": [q.tolist() for q in qs], "k": 3})
    assert code == 200
    Q, qm = preprocess_queries(_obj(qs), None, length_multiple=8)
    vals, idx = eng.search_dense(Q, qm, k=3)
    assert body["docids"] == eng.ids_for(idx)
    # the same rows in another batch: f32 sums may regroup -> 1e-5
    np.testing.assert_allclose(body["scores"], vals, atol=1e-5)
    # concurrent requests coalesce and still answer per request
    out = [None] * 6

    def one(i):
        out[i] = _post(url + "/search", {"queries": [qs[i % 4].tolist()],
                                         "k": 2})

    threads = [threading.Thread(target=one, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert all(not t.is_alive() for t in threads)
    for i, (code, b) in enumerate(out):
        assert code == 200 and b["docids"][0] == body["docids"][i % 4][:2]
    code, metrics = _get(url + "/metrics")
    assert code == 200 and "evdr_requests_total" in metrics
    n = int(next(line.split()[1] for line in metrics.splitlines()
                 if line.startswith("evdr_requests_total")))
    assert n >= 7


def _metric(text, name):
    return float(next(line.split()[1] for line in text.splitlines()
                      if line.startswith(name + " ")))


def test_metrics_histogram_the_queue_wait_of_every_request(server, corpus):
    _, url = server
    q = np.asarray(corpus["query"][0], np.float32).tolist()
    for _ in range(2):
        assert _post(url + "/search", {"queries": [q], "k": 2})[0] == 200
    code, metrics = _get(url + "/metrics")
    assert code == 200 and "# TYPE evdr_queue_wait_ms histogram" in metrics
    n = _metric(metrics, "evdr_requests_total")
    assert n >= 2
    assert _metric(metrics, "evdr_queue_wait_ms_count") == n
    assert _metric(metrics, 'evdr_queue_wait_ms_bucket{le="+Inf"}') == n
    assert _metric(metrics, "evdr_queue_wait_ms_sum") >= 0.0


def _obj(arrs):
    o = np.empty(len(arrs), dtype=object)
    for i, a in enumerate(arrs):
        o[i] = a
    return o


def test_unported_endpoints_and_bad_requests(server, corpus, tmp_path):
    """/add, /delete and /save answer 200 through the engine's incremental
    methods (a server of its own, so the shared one stays unchanged);
    /save is 403 without --save_dir and 400 for a path outside it; bad
    searches are 400, unknown paths 404."""
    _, url = server
    assert _post(url + "/save", {"path": "x.npz"})[0] == 403
    c = corpus
    eng = RetrievalEngine(dtype="bfloat16", device="cpu").build_from_ragged(
        c["documents"], c["doc_attnmask"], c["doc_imgmask"],
        docids=c["docid"])
    srv = serve_http.make_server(eng, port=0, save_dir=tmp_path)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    mine = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        doc = np.asarray(c["query"][0], np.float32)
        assert _post(mine + "/add", {"documents": [doc.tolist()],
                                     "docids": ["new"]}) == (
            200, {"added": 1, "n_docs": 31})
        code, body = _post(mine + "/search", {"queries": [doc.tolist()],
                                              "k": 1})
        assert code == 200 and body["docids"] == [["new"]]
        gone = str(c["docid"][0])
        assert _post(mine + "/delete", {"docids": [gone, "nope"]}) == (
            200, {"deleted": 1, "n_docs": 30})
        assert _post(mine + "/save", {"path": "snap.npz"}) == (
            200, {"saved": str(tmp_path / "snap.npz"), "n_docs": 30})
        assert _post(mine + "/save", {"path": "../out.npz"})[0] == 400
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)
    back = RetrievalEngine.from_npz(tmp_path / "snap.npz", dtype="bfloat16",
                                    device="cpu")
    assert back.n_docs == 30 and "new" in list(back.index.docids)
    assert gone not in list(back.index.docids)
    assert _post(url + "/search", {"queries": [[[0.0] * 7]]})[0] == 400
    assert _post(url + "/search", {"queries": [[[1.0] * 32]], "k": 0})[0] \
        == 400
    assert _post(url + "/search", {"queries": [[[1.0] * 32]],
                                   "n_candidates": 8})[0] == 400
    assert _post(url + "/nope", {})[0] == 404


def test_search_cli_writes_trec_run_like_jax_cli(tmp_path, corpus):
    path = tmp_path / "c.npz"
    save_synthetic_npz(path, corpus)
    run = tmp_path / "run.trec"
    search.main(["--index", str(path), "--queries", str(path), "--k", "3",
                 "--out", str(run), "--device", "cpu"])
    lines = run.read_text().splitlines()
    assert len(lines) == 8 * 3
    qkeys, ids, _, summary = search.run_search(path, path, k=3,
                                               device="cpu")
    assert summary["impl"] == "plain" and summary["n_docs"] == 30
    jk, jids, _, _ = jax_run_search(path, path, k=3, impl="xla")
    assert qkeys == jk
    assert [r[0] for r in ids] == [r[0] for r in jids]  # top-1 identical
    assert lines[0].split()[2] == ids[0][0]


def test_serve_cli_rejects_multihost(tmp_path):
    with pytest.raises(SystemExit):
        serve_http.main(["--index", str(tmp_path / "x.npz"), "--multihost"])


def test_serve_cli_passes_save_dir(tmp_path, corpus, monkeypatch):
    """--save_dir reaches make_server (the JAX CLI's flag)."""
    path = tmp_path / "c.npz"
    save_synthetic_npz(path, corpus)
    seen = {}

    def fake_make_server(eng, *a, save_dir=None, **kw):
        seen["save_dir"], seen["n_docs"] = save_dir, eng.n_docs
        raise KeyboardInterrupt

    monkeypatch.setattr(serve_http, "make_server", fake_make_server)
    with pytest.raises(KeyboardInterrupt):
        serve_http.main(["--index", str(path), "--device", "cpu",
                         "--save_dir", str(tmp_path), "--warm", "1"])
    assert seen == {"save_dir": str(tmp_path), "n_docs": 30}
