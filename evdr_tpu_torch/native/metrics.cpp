// Fast retrieval-metrics engine: nDCG/mAP/Recall/Precision/MRR @ k.
//
// Computes trec_eval-convention metrics directly from a dense (nq, nd) score
// matrix and CSR-encoded qrels, replacing the Python dict-of-docid path
// (evdr_tpu/eval/metrics.py) in the training loop's periodic eval. Semantics
// match the Python reference exactly, including score ties broken by docid in
// descending lexicographic order (callers pass `tie_rank`: the rank of each
// doc index under that ordering).
//
// Build: g++ -O3 -march=native -shared -fPIC -o libevdr_metrics.so metrics.cpp
// ABI: plain C, driven from Python via ctypes.

#include <algorithm>
#include <cstdint>
#include <cmath>
#include <cstring>
#include <vector>

extern "C" {

// scores:       (n_rows, nd) row-major float32
// nq:           number of JUDGED queries (qrels entries) — the averaging unit
// row_map:      (nq,) int64 — score row for judged query i, or -1 if the
//               query has no scores (contributes zeros, like the dict path)
// tie_rank:     (nd,) int32 — rank of doc j under descending-docid ordering
//               (0 = lexicographically LAST docid, ranked first on ties)
// qrels CSR:    for judged query i, docs qrels_doc[indptr[i]:indptr[i+1]]
//               with integer relevance qrels_rel[...]
// ks:           (nk,) cutoffs, ascending not required
// out:          (5, nk) doubles — [ndcg, map, recall, precision, mrr] sums
//               over judged queries (caller divides by nq and rounds)
void evdr_compute_metrics(const float* scores, int64_t nq, int64_t nd,
                          const int64_t* row_map,
                          const int32_t* tie_rank,
                          const int64_t* qrels_indptr,
                          const int32_t* qrels_doc,
                          const int32_t* qrels_rel,
                          const int32_t* ks, int64_t nk,
                          double* out) {
  int32_t kmax = 0;
  for (int64_t i = 0; i < nk; ++i) kmax = std::max(kmax, ks[i]);
  const int64_t depth = std::min<int64_t>(kmax, nd);

  std::memset(out, 0, sizeof(double) * 5 * nk);

  std::vector<int32_t> order(nd);
  std::vector<int32_t> top(depth);
  // int32: relevance must stay unclamped so DCG and IDCG see identical gains
  // (an int8 clamp at 127 would skew nDCG for judgments with rel > 127)
  std::vector<int32_t> rel_of_doc(nd, 0);
  std::vector<double> disc(depth + 1);
  for (int64_t r = 1; r <= depth; ++r) disc[r] = 1.0 / std::log2((double)r + 1.0);

  for (int64_t q = 0; q < nq; ++q) {
    const bool has_row = row_map[q] >= 0;
    const float* row = has_row ? scores + row_map[q] * nd : nullptr;

    // partial top-`depth` selection by (-score, tie_rank)
    if (has_row) {
      for (int64_t j = 0; j < nd; ++j) order[j] = (int32_t)j;
      auto cmp = [&](int32_t a, int32_t b) {
        if (row[a] != row[b]) return row[a] > row[b];
        return tie_rank[a] < tie_rank[b];
      };
      if (depth < nd) {
        std::partial_sort(order.begin(), order.begin() + depth, order.end(), cmp);
      } else {
        std::sort(order.begin(), order.end(), cmp);
      }
      std::copy(order.begin(), order.begin() + depth, top.begin());
    } else {
      std::fill(top.begin(), top.end(), -1);
    }

    // mark this query's relevance judgments
    const int64_t lo = qrels_indptr[q], hi = qrels_indptr[q + 1];
    int64_t n_rel_pos = 0;
    std::vector<int32_t> ideal_rels;
    ideal_rels.reserve(hi - lo);
    for (int64_t t = lo; t < hi; ++t) {
      if (qrels_doc[t] >= 0 && qrels_doc[t] < nd)
        rel_of_doc[qrels_doc[t]] = qrels_rel[t];
      if (qrels_rel[t] > 0) {
        ++n_rel_pos;
        ideal_rels.push_back(qrels_rel[t]);
      }
    }
    std::sort(ideal_rels.begin(), ideal_rels.end(), std::greater<int32_t>());

    // prefix stats over the ranked list
    // hits[r], dcg[r], ap_sum[r] for r = 1..depth
    std::vector<int32_t> hits(depth + 1, 0);
    std::vector<double> dcg(depth + 1, 0.0), ap(depth + 1, 0.0);
    for (int64_t r = 1; r <= depth; ++r) {
      const int32_t d = top[r - 1];
      const int32_t rel = (d >= 0) ? rel_of_doc[d] : 0;
      hits[r] = hits[r - 1] + (rel > 0 ? 1 : 0);
      dcg[r] = dcg[r - 1] + (double)rel * disc[r];
      ap[r] = ap[r - 1] + (rel > 0 ? (double)hits[r] / (double)r : 0.0);
    }
    // first relevant rank (for MRR)
    int64_t first_rel = 0;
    for (int64_t r = 1; r <= depth; ++r) {
      const int32_t d = top[r - 1];
      if (d >= 0 && rel_of_doc[d] > 0) { first_rel = r; break; }
    }
    // ideal DCG prefix
    std::vector<double> idcg(depth + 1, 0.0);
    for (int64_t r = 1; r <= depth; ++r) {
      const double g = (r <= (int64_t)ideal_rels.size()) ? (double)ideal_rels[r - 1] : 0.0;
      idcg[r] = idcg[r - 1] + g * disc[r];
    }

    for (int64_t i = 0; i < nk; ++i) {
      const int64_t k = std::min<int64_t>(ks[i], depth);
      if (k <= 0) continue;
      out[0 * nk + i] += (idcg[k] > 0.0) ? dcg[k] / idcg[k] : 0.0;      // nDCG
      out[1 * nk + i] += (n_rel_pos > 0) ? ap[k] / (double)n_rel_pos : 0.0;  // MAP
      out[2 * nk + i] += (n_rel_pos > 0) ? (double)hits[k] / (double)n_rel_pos : 0.0;  // Recall
      out[3 * nk + i] += (double)hits[k] / (double)ks[i];               // P@k
      out[4 * nk + i] += (first_rel > 0 && first_rel <= k) ? 1.0 / (double)first_rel : 0.0;  // MRR
    }

    // clear relevance marks for the next query
    for (int64_t t = lo; t < hi; ++t)
      if (qrels_doc[t] >= 0 && qrels_doc[t] < nd) rel_of_doc[qrels_doc[t]] = 0;
  }
}

}  // extern "C"
