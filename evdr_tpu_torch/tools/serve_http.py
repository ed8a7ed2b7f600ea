"""evdr-serve-torch — minimal HTTP retrieval server over a saved index, on a GPU.

Online counterpart of the batch ``evdr-search-torch`` CLI: load an index npz
once (interchange or packed; any storage dtype), warm the kernels, then
answer search requests over HTTP. Stdlib-only
(ThreadingHTTPServer). Device work runs on a single dispatcher thread that
dynamically COALESCES concurrent requests into shared batches
(:class:`MicroBatcher`), so the GPU scores one larger batch instead of
many small ones.

    python -m evdr_tpu_torch.tools.serve_http --index features/dump_all.npz \
        --port 8080 [--dtype int8|int4|pq [--quantize_queries]] [--device cpu]
        [--prune_centroids 4 --n_candidates 512 [--summary_dtype int8]]
        [--save_dir snapshots/]
        [--multihost --coordinator HOST:PORT --num_processes N
         --process_id I [--dist_backend nccl|gloo] [--local_shards S]]

``--multihost`` serves one index over one process per GPU
(``parallel/multihost.py``): every process loads only its own doc shards
of a packed file, process 0 answers HTTP and broadcasts each search and
mutation, the others mirror it (``MultihostSearchCoordinator.follow``).
``--dist_backend`` is explicit: its default is ``nccl`` for a GPU and
``gloo`` on the CPU; several processes on one GPU need ``gloo``.

API:
- ``GET /healthz`` -> ``{"status": "ok", "n_docs": N, "impl": ..., ...,
  "mesh": {"shards": S, "processes": P, "backend": ...}}``
- ``GET /metrics`` -> Prometheus text exposition of the serving counters
- ``POST /search`` with JSON body
  ``{"queries": [[[...dim floats...] per token] per query],
     "attnmask": [[bool per token] per query]   (optional),
     "k": 10                                    (optional),
     "n_candidates": 512                        (optional, pruned engines)}``
  -> ``{"docids": [[...] per query], "scores": [[...] per query],
        "latency_ms_per_query": ...}``
- ``POST /add`` ``{"documents": [[[...] per token] per doc], "docids":
  [...] (optional), "attnmask": ... (optional)}`` -> ``{"added": n,
  "n_docs": N}`` (engine.add_ragged: a tail index merged into every
  search; an existing docid is replaced)
- ``POST /delete`` ``{"docids": [...]}`` -> ``{"deleted": n, "n_docs": N}``
- ``POST /save`` ``{"path": "name.npz"}`` -> ``{"saved": path, "n_docs":
  N}``: the current corpus as a packed npz, only as a ``*.npz`` file
  directly under ``--save_dir`` (403 without the flag, 400 for any other
  path)

``n_docs`` counts live docs (main + added - deleted).

Where the time of a request goes: each request carries its submit time
and the start time of its dispatch (``_BatchReq.t_submit``,
``t_start``); ``GET /metrics`` shows the queue wait ``t_start -
t_submit`` as ``evdr_queue_wait_ms``. ``utils/timing.trace_ctx`` around
a server run records the ``evdr.`` spans of every thread: the
dispatcher's ``evdr.batcher.wait`` and ``evdr.batcher.dispatch`` (with
``assemble``, the engine's search and ``scatter`` inside), beside the
handlers' threads.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from evdr_tpu_torch.utils.timing import span


def _batch_bucket(n: int) -> int:
    """Smallest power-of-two >= n: request batch sizes snap to a handful of
    shapes, the ones the server warms at start-up."""
    b = 1
    while b < n:
        b *= 2
    return b


def bucket_queries(Q, qmask):
    """Pad (nq, Lq, D) queries up the batch axis to the power-of-two bucket.

    Padded rows are fully masked (qmask False) so they are inert in the
    scoring kernel; callers slice results back to the true nq."""
    nq = Q.shape[0]
    nb = _batch_bucket(nq)
    if nb > nq:
        Q = np.pad(Q, ((0, nb - nq), (0, 0), (0, 0)))
        qmask = np.pad(qmask, ((0, nb - nq), (0, 0)))
    return Q, qmask


class ServeStats:
    """Thread-safe serving counters + histograms, rendered at GET /metrics
    in the Prometheus text exposition format (stdlib-only, like the rest
    of the daemon). Tracks request latency (which includes queue wait in a
    coalesced group — the number an operator tunes ``--batch_wait_ms``
    against), the queue wait alone (submit to the start of the request's
    dispatch), per-dispatch group sizes, query counts, and error
    classes."""

    LAT_MS = (5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0)
    GROUP = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)

    def __init__(self):
        self._lock = threading.Lock()
        self.requests = 0
        self.queries = 0
        self.errors = {"4xx": 0, "5xx": 0}
        self.dispatches = 0
        self._lat = [0] * (len(self.LAT_MS) + 1)
        self._lat_sum = 0.0
        self._wait = [0] * (len(self.LAT_MS) + 1)
        self._wait_sum = 0.0
        self._grp = [0] * (len(self.GROUP) + 1)
        self._grp_sum = 0

    @staticmethod
    def _bucketize(hist, buckets, v):
        for i, b in enumerate(buckets):
            if v <= b:
                hist[i] += 1
                return
        hist[-1] += 1

    def observe_request(self, n_queries: int, ms: float,
                        wait_ms: float) -> None:
        with self._lock:
            self.requests += 1
            self.queries += int(n_queries)
            self._lat_sum += ms
            self._bucketize(self._lat, self.LAT_MS, ms)
            self._wait_sum += wait_ms
            self._bucketize(self._wait, self.LAT_MS, wait_ms)

    def observe_error(self, code: int) -> None:
        with self._lock:
            self.errors["4xx" if code < 500 else "5xx"] += 1

    def observe_dispatch(self, group_size: int) -> None:
        with self._lock:
            self.dispatches += 1
            self._grp_sum += int(group_size)
            self._bucketize(self._grp, self.GROUP, group_size)

    @staticmethod
    def _hist_lines(name, hist, buckets, total_sum, count):
        out, cum = [], 0
        for i, b in enumerate(buckets):
            cum += hist[i]
            out.append(f'{name}_bucket{{le="{b:g}"}} {cum}')
        cum += hist[-1]
        out.append(f'{name}_bucket{{le="+Inf"}} {cum}')
        out.append(f"{name}_sum {total_sum:g}")
        out.append(f"{name}_count {count}")
        return out

    def render(self) -> str:
        with self._lock:
            lines = [
                "# TYPE evdr_requests_total counter",
                f"evdr_requests_total {self.requests}",
                "# TYPE evdr_queries_total counter",
                f"evdr_queries_total {self.queries}",
                "# TYPE evdr_errors_total counter",
                f'evdr_errors_total{{class="4xx"}} {self.errors["4xx"]}',
                f'evdr_errors_total{{class="5xx"}} {self.errors["5xx"]}',
                "# TYPE evdr_dispatches_total counter",
                f"evdr_dispatches_total {self.dispatches}",
                "# TYPE evdr_request_latency_ms histogram",
                *self._hist_lines("evdr_request_latency_ms", self._lat,
                                  self.LAT_MS, self._lat_sum, self.requests),
                "# TYPE evdr_queue_wait_ms histogram",
                *self._hist_lines("evdr_queue_wait_ms", self._wait,
                                  self.LAT_MS, self._wait_sum,
                                  self.requests),
                "# TYPE evdr_dispatch_group_size histogram",
                *self._hist_lines("evdr_dispatch_group_size", self._grp,
                                  self.GROUP, self._grp_sum,
                                  self.dispatches),
            ]
        return "\n".join(lines) + "\n"


class _BatchReq:
    """One in-flight /search request awaiting a coalesced dispatch. Its
    counters: ``t_submit`` (``time.perf_counter()`` at ``submit``) and
    ``t_start`` (at the start of its dispatch; None until then)."""

    __slots__ = ("Q", "qmask", "k", "n_cand", "done", "vals", "idx", "err",
                 "batched_with", "t_submit", "t_start")

    def __init__(self, Q, qmask, k, n_cand):
        self.Q, self.qmask, self.k, self.n_cand = Q, qmask, k, n_cand
        self.done = threading.Event()
        self.vals = self.idx = self.err = None
        self.batched_with = 1
        self.t_submit = self.t_start = None

    @property
    def wait_ms(self) -> float:
        """The queue wait: submit to the start of the request's dispatch."""
        return (self.t_start - self.t_submit) * 1000.0


class MicroBatcher:
    """Dynamic request coalescing: concurrent searches share ONE device
    dispatch instead of queueing for the chip one by one.

    Every dispatch pays a fixed cost (launches, host transfers, the top-k
    selection) whatever its batch size, so under concurrency the
    lock-per-request pattern wastes most of the queue wait. A single
    dispatcher thread drains whatever accumulated
    while the previous dispatch was in flight ("natural batching" — zero
    added latency when idle), pads entries to a common token length,
    concatenates along the batch axis, runs one search, and scatters the
    results back. ``wait_ms > 0`` additionally holds the first request of
    a group back to let followers pile in (a latency/throughput knob,
    default off). Requests only group when their ``n_candidates`` agree.

    The reference repo has no serving path at all; this mirrors what
    production model servers do (dynamic batching a la Triton/TF-Serving).
    """

    def __init__(self, engine, wait_ms: float = 0.0, max_batch: int = 64,
                 stats: ServeStats | None = None,
                 engine_lock: threading.Lock | None = None):
        self.engine = engine
        self.stats = stats
        # shared with mutating endpoints (/add, /delete): a tail rebuild
        # must not interleave with an in-flight dispatch
        self.engine_lock = engine_lock or threading.Lock()
        self.wait_s = max(0.0, wait_ms / 1000.0)
        self.max_batch = max(1, max_batch)
        self._cv = threading.Condition()
        self._pending: list[_BatchReq] = []
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="evdr-serve-batcher")
        self._thread.start()

    def close(self) -> None:
        """Stop the dispatcher thread (drains queued requests first).
        Without this every make_server leaks an immortal daemon thread
        pinning the engine's device buffers; the server's ``server_close``
        calls it."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=30)

    # ------------------------------------------------------------- request
    def submit(self, Q, qmask, k: int, n_candidates=None) -> _BatchReq:
        """Enqueue a search; the returned request resolves (``done`` set,
        ``vals``/``idx``/``err`` + ``batched_with`` filled) after its
        shared dispatch."""
        req = _BatchReq(np.asarray(Q), np.asarray(qmask), int(k),
                        n_candidates)
        req.t_submit = time.perf_counter()
        with self._cv:
            self._pending.append(req)
            self._cv.notify()
        return req

    def search_dense(self, Q, qmask, k: int, n_candidates=None):
        """Same contract as ``engine.search_dense`` (drop-in), but
        dispatches ride shared batches."""
        req = self.submit(Q, qmask, k, n_candidates)
        req.done.wait()
        if req.err is not None:
            raise req.err
        return req.vals, req.idx

    # ---------------------------------------------------------- dispatcher
    def _take_group(self) -> list[_BatchReq]:
        """Block until work exists, optionally linger ``wait_s`` for
        followers, then remove and return one compatible group (span
        ``evdr.batcher.wait``: the dispatcher's idle time)."""
        with span("evdr.batcher.wait"), self._cv:
            while not self._pending:
                if self._closed:
                    return []
                self._cv.wait()
            if self.wait_s > 0.0 and not self._closed:
                deadline = time.monotonic() + self.wait_s
                while len(self._pending) < self.max_batch:
                    left = deadline - time.monotonic()
                    if left <= 0 or not self._cv.wait(timeout=left):
                        break
            key = self._pending[0].n_cand
            group, rest = [], []
            for r in self._pending:
                if r.n_cand == key and len(group) < self.max_batch:
                    group.append(r)
                else:
                    rest.append(r)
            self._pending = rest
        return group

    def _dispatch(self, group: list[_BatchReq]) -> None:
        t_start = time.perf_counter()
        for r in group:
            r.t_start = t_start
        if self.stats is not None:
            self.stats.observe_dispatch(len(group))
        with span("evdr.batcher.dispatch"):
            try:
                with span("evdr.batcher.assemble"):
                    lq = max(r.Q.shape[1] for r in group)
                    parts_q, parts_m = [], []
                    for r in group:
                        pad = lq - r.Q.shape[1]
                        parts_q.append(np.pad(r.Q, ((0, 0), (0, pad), (0, 0)))
                                       if pad else r.Q)
                        parts_m.append(np.pad(r.qmask, ((0, 0), (0, pad)))
                                       if pad else r.qmask)
                    # mixed query dims raise out of np.concatenate and
                    # scatter to the whole group as a 500 (one engine
                    # serves one index dim)
                    Q = np.concatenate(parts_q, axis=0)
                    qmask = np.concatenate(parts_m, axis=0)
                    Q, qmask = bucket_queries(Q, qmask)
                    k = max(r.k for r in group)
                with self.engine_lock:
                    vals, idx = self.engine.search_dense(
                        Q, qmask, k=k, n_candidates=group[0].n_cand)
                with span("evdr.batcher.scatter"):
                    vals, idx = np.asarray(vals), np.asarray(idx)
                    row = 0
                    for r in group:
                        nq = r.Q.shape[0]
                        r.vals = vals[row:row + nq, : r.k]
                        r.idx = idx[row:row + nq, : r.k]
                        r.batched_with = len(group)
                        row += nq
            except Exception as e:  # noqa: BLE001 — scatter, keep the loop
                for r in group:
                    r.err = e
            finally:
                for r in group:
                    r.done.set()

    def _loop(self) -> None:
        while True:
            group = self._take_group()
            if not group:  # closed AND drained
                return
            self._dispatch(group)


def warm_query_dim(engine) -> int:
    """Token dim for the warm-up queries (engine.dim; kept as a named
    helper because the handlers and CLI cite it as the request-dim gate)."""
    return engine.dim


def make_server(engine, host: str = "127.0.0.1", port: int = 8080,
                default_k: int = 10, default_candidates: int = 0,
                max_body_mb: int = 256, length_multiple: int = 8,
                batch_wait_ms: float = 0.0, max_batch: int = 64,
                save_dir=None):
    """Build a ThreadingHTTPServer wired to a built RetrievalEngine.

    Concurrent /search requests coalesce into shared device dispatches
    through a :class:`MicroBatcher` (which also serializes chip access —
    one scoring program in flight)."""
    from evdr_tpu_torch.data.packing import preprocess_queries

    stats = ServeStats()
    batcher = MicroBatcher(engine, wait_ms=batch_wait_ms,
                           max_batch=max_batch, stats=stats)
    max_body = max_body_mb * (1 << 20)
    expected_d = warm_query_dim(engine)

    class Server(ThreadingHTTPServer):
        def server_close(self):
            batcher.close()  # stop the dispatcher thread with the server
            super().server_close()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _reply(self, code: int, obj) -> None:
            if code >= 400:
                stats.observe_error(code)
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/metrics":
                body = stats.render().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if self.path != "/healthz":
                return self._reply(404, {"error": "unknown path"})
            mesh = getattr(engine, "mesh", None)
            self._reply(200, {
                "status": "ok", "n_docs": engine.n_docs,
                "dtype": engine.dtype, "impl": engine.impl,
                "device": str(engine.device),
                "pruned": engine.summary is not None,
                "mesh": {"shards": 1 if mesh is None else mesh.size,
                         "processes": 1 if mesh is None else mesh.world,
                         "backend": None if mesh is None else mesh.backend},
            })

        def _read_json(self):
            n = int(self.headers.get("Content-Length", 0))
            if n > max_body:
                self._reply(413, {"error": f"body {n} bytes exceeds "
                                           f"{max_body} cap"})
                return None
            return json.loads(self.rfile.read(n))

        def do_POST(self):
            if self.path == "/add":
                return self._do_add()
            if self.path == "/delete":
                return self._do_delete()
            if self.path == "/save":
                return self._do_save()
            if self.path != "/search":
                return self._reply(404, {"error": "unknown path"})
            try:
                req = self._read_json()
                if req is None:
                    return
                queries = req["queries"]
                if not queries:
                    return self._reply(400, {"error": "empty queries"})
                qobj = np.empty(len(queries), dtype=object)
                for i, q in enumerate(queries):
                    qobj[i] = np.asarray(q, dtype=np.float32)
                am = req.get("attnmask")
                amobj = None
                if am is not None:
                    amobj = np.empty(len(am), dtype=object)
                    for i, m in enumerate(am):
                        amobj[i] = np.asarray(m, dtype=bool)
                # snap the token axis to its bucket here; the batch axis is
                # bucketed AFTER coalescing (MicroBatcher concatenates the
                # group, then pads the combined batch to a power of two)
                Q, qmask = preprocess_queries(
                    qobj, amobj, length_multiple=length_multiple)
                if Q.shape[2] != expected_d:
                    # reject BEFORE submit: a wrong-dim request inside a
                    # coalesced group would fail the whole group's dispatch
                    return self._reply(400, {
                        "error": f"query dim {Q.shape[2]} != index dim "
                                 f"{expected_d}"})
                # clamp to the real doc count: beyond it top-k would surface
                # index-padding rows (-inf scores, out-of-range docids)
                k = min(int(req.get("k", default_k)), engine.n_docs)
                if k < 1:
                    # reject BEFORE submit: the group dispatches at max-k
                    # and slices per request, so a negative k would return
                    # a silently truncated 200 instead of an error
                    return self._reply(400, {"error": f"k must be >= 1, "
                                                      f"got {k}"})
                n_cand = int(req.get("n_candidates", default_candidates)) or None
                t0 = time.perf_counter()
                breq = batcher.submit(Q, qmask, k=k, n_candidates=n_cand)
                breq.done.wait()
                if breq.err is not None:
                    raise breq.err
                vals, idx = breq.vals, breq.idx
                total_ms = (time.perf_counter() - t0) * 1000.0
                stats.observe_request(len(queries), total_ms,
                                      breq.wait_ms)
                ms = total_ms / len(queries)
                reply = {"docids": engine.ids_for(idx),
                         "scores": np.asarray(vals).tolist(),
                         "latency_ms_per_query": round(ms, 3),
                         "batched_with": breq.batched_with}
                if np.asarray(idx).shape[1] < k:
                    # a /delete racing the coalesced dispatch can shrink
                    # the corpus below the k clamped above; say so instead
                    # of silently returning fewer rows than requested
                    reply["truncated_to"] = int(np.asarray(idx).shape[1])
                self._reply(200, reply)
            except (KeyError, ValueError, TypeError, IndexError,
                    json.JSONDecodeError) as e:
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:  # CUDA/runtime errors: JSON 500, keep the
                self._reply(500, {  # connection alive instead of dropping it
                    "error": f"{type(e).__name__}: {e}"})

        def _do_add(self):
            """Incremental document addition: serves from a tail index
            merged into every search (engine.add)."""
            try:
                req = self._read_json()
                if req is None:
                    return
                docs = req["documents"]
                if not docs:
                    return self._reply(400, {"error": "empty documents"})
                dobj = np.empty(len(docs), dtype=object)
                for i, dmat in enumerate(docs):
                    dobj[i] = np.asarray(dmat, dtype=np.float32)
                am = req.get("attnmask")
                amobj = None
                if am is not None:
                    amobj = np.empty(len(am), dtype=object)
                    for i, msk in enumerate(am):
                        amobj[i] = np.asarray(msk, dtype=bool)
                if not hasattr(engine, "add_ragged"):
                    return self._reply(501, {
                        "error": "engine does not support incremental add"})
                with batcher.engine_lock:  # not during an in-flight dispatch
                    added = engine.add_ragged(dobj, amobj,
                                              docids=req.get("docids"))
                self._reply(200, {"added": added, "n_docs": engine.n_docs})
            except (KeyError, ValueError, TypeError, IndexError,
                    json.JSONDecodeError, NotImplementedError) as e:
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        def _do_save(self):
            """Persist the current logical corpus (incremental state
            folded in) as a packed npz under the allowlisted save
            directory — a client-supplied free path would let any peer
            that can reach the port overwrite arbitrary server files."""
            import os

            try:
                req = self._read_json()
                if req is None:
                    return
                if save_dir is None:
                    return self._reply(403, {
                        "error": "saving disabled; start evdr-serve with "
                                 "--save_dir DIR to allow it"})
                name = str(req["path"])
                root = os.path.realpath(str(save_dir))
                path = os.path.realpath(os.path.join(root, name))
                if os.path.dirname(path) != root \
                        or not path.endswith(".npz"):
                    return self._reply(400, {
                        "error": "path must be a *.npz filename directly "
                                 "under the configured --save_dir"})
                if not hasattr(engine, "to_packed_payload"):
                    return self._reply(501, {
                        "error": "engine does not support saving"})
                # hold the dispatch lock only for the state snapshot; the
                # multi-second disk write of a GB-scale payload must not
                # stall every queued /search behind it
                with batcher.engine_lock:
                    payload = engine.to_packed_payload()
                    n_docs = engine.n_docs
                engine.write_packed_npz(path, payload)
                self._reply(200, {"saved": path, "n_docs": n_docs})
            except NotImplementedError as e:
                self._reply(501, {"error": f"{type(e).__name__}: {e}"})
            except (KeyError, ValueError, TypeError,
                    json.JSONDecodeError) as e:
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:  # OSError (disk full, perms) included:
                self._reply(500, {  # server-side fault, not a client bug
                    "error": f"{type(e).__name__}: {e}"})

        def _do_delete(self):
            """Tombstone documents by docid (engine.delete)."""
            try:
                req = self._read_json()
                if req is None:
                    return
                ids = req["docids"]
                if not hasattr(engine, "delete"):
                    return self._reply(501, {
                        "error": "engine does not support deletion"})
                with batcher.engine_lock:
                    removed = engine.delete([str(d) for d in ids])
                self._reply(200, {"deleted": removed,
                                  "n_docs": engine.n_docs})
            except (KeyError, ValueError, TypeError,
                    json.JSONDecodeError) as e:
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return Server((host, port), Handler)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--index", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--dtype",
                   choices=("float32", "bfloat16", "int8", "int4", "pq"),
                   default="bfloat16")
    p.add_argument("--impl", default="auto")
    p.add_argument("--prune_centroids", type=int, default=0)
    p.add_argument("--summary_dtype", default=None,
                   choices=("bfloat16", "int8", "int4"),
                   help="storage tier of the stage-1 pruning summaries "
                        "(default: engine dtype; bf16 for pq)")
    p.add_argument("--n_candidates", type=int, default=0)
    p.add_argument("--quantize_queries", action="store_true")
    p.add_argument("--device", default=None,
                   help="'cuda' (default) or 'cpu' for the plain path")
    p.add_argument("--max_body_mb", type=int, default=256)
    p.add_argument("--length_multiple", type=int, default=8,
                   help="query token axis pads to a multiple of this")
    p.add_argument("--batch_wait_ms", type=float, default=0.0,
                   help="hold the first request of a dispatch group this "
                        "long for followers to coalesce (0 = natural "
                        "batching only: group whatever queued while the "
                        "previous dispatch was in flight)")
    p.add_argument("--max_batch", type=int, default=64,
                   help="max requests coalesced into one device dispatch")
    p.add_argument("--save_dir", default=None,
                   help="directory POST /save may write *.npz snapshots "
                        "into (endpoint disabled when omitted)")
    p.add_argument("--warm", default="1,8,32",
                   help="comma list of batch buckets to run once before "
                        "serving (the first call builds and loads the "
                        "kernels)")
    p.add_argument("--multihost", action="store_true",
                   help="one process per GPU (parallel/multihost.py): "
                        "every process loads its own doc shards; process 0 "
                        "serves HTTP and broadcasts each search, the rest "
                        "mirror it")
    p.add_argument("--coordinator", default=None,
                   help="multihost: process 0's host:port")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--dist_backend", choices=("nccl", "gloo"), default=None,
                   help="multihost: the process group's backend (default "
                        "nccl on a GPU, gloo on the CPU; several processes "
                        "on one GPU need gloo)")
    p.add_argument("--local_shards", type=int, default=1,
                   help="multihost: doc shards a process holds")
    p.add_argument("--mesh_docs", type=int, default=1,
                   help="one process: shard the index over this many GPUs")
    a = p.parse_args(argv)

    mesh = None
    if a.multihost:
        from evdr_tpu_torch.engine import resolve_device
        from evdr_tpu_torch.parallel.multihost import (global_doc_mesh,
                                                       init_multihost)

        if not (a.coordinator and a.num_processes and a.process_id
                is not None):
            p.error("--multihost needs --coordinator, --num_processes and "
                    "--process_id")
        backend = a.dist_backend or (
            "nccl" if resolve_device(a.device).type == "cuda" else "gloo")
        init_multihost(a.coordinator, a.num_processes, a.process_id,
                       backend)
        mesh = global_doc_mesh(a.local_shards, device=a.device)
        print(f"[serve] multihost process {mesh.rank}/{mesh.world} "
              f"({backend}): {mesh.size} doc shards, {mesh.n_local} on "
              f"{mesh.devices[0]}", flush=True)
    elif a.mesh_docs > 1:
        from evdr_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(a.mesh_docs, device=a.device or "cuda")

    from evdr_tpu_torch.engine import RetrievalEngine

    print(f"[serve] loading index {a.index}", flush=True)
    eng = RetrievalEngine.from_npz(
        a.index, mmap=a.multihost, dtype=a.dtype, impl=a.impl,
        quantize_queries=a.quantize_queries,
        device=None if mesh else a.device, mesh=mesh,
        prune_centroids=a.prune_centroids, summary_dtype=a.summary_dtype)
    coord = None
    if a.multihost:
        from evdr_tpu_torch.parallel.multihost import (
            MultihostSearchCoordinator)

        coord = MultihostSearchCoordinator(eng)
        if mesh.rank != 0:
            print(f"[serve] follower {mesh.rank} mirroring process 0",
                  flush=True)
            coord.follow()
            return
        eng = coord  # every search and mutation broadcasts first
    d = warm_query_dim(eng)
    for b in sorted({int(x) for x in a.warm.split(",") if x.strip()}):
        warm = np.zeros((b, a.length_multiple, d), np.float32)
        wm = np.zeros((b, a.length_multiple), bool)
        wm[:, 0] = True  # one valid token: exercises the real masked path
        eng.search_dense(warm, wm, k=min(a.k, eng.n_docs),
                         n_candidates=a.n_candidates or None)
        print(f"[serve] warmed batch bucket {b}", flush=True)
    srv = make_server(eng, a.host, a.port, default_k=a.k,
                      default_candidates=a.n_candidates,
                      max_body_mb=a.max_body_mb,
                      length_multiple=a.length_multiple,
                      batch_wait_ms=a.batch_wait_ms, max_batch=a.max_batch,
                      save_dir=a.save_dir)
    print(f"[serve] {eng.n_docs} docs ready on http://{a.host}:{a.port} "
          f"({eng.impl} on {eng.device})", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        if coord is not None:
            # release the followers from their broadcast wait
            coord.stop()


if __name__ == "__main__":
    main()
