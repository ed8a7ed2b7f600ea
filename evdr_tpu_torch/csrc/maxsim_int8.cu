// K2: fused masked MaxSim over an int8 page index (per-token f32 scales),
// for Hopper (sm_90a).
//
// Replaces: evdr_tpu/ops/pallas_maxsim.py:_kernel_int8 with _int8_simT
// (driver _maxsim_int8_impl, public entries maxsim_pallas_int8full and
// maxsim_pallas_int8).
//
// Two entry points share one tile loop (maxsim_tile.cuh):
// - evdr_maxsim_int8full: int8 queries (quantized per token on the device
//   before the launch) x int8 codes on the int8 tensor cores (mma.sync
//   m16n8k32 s8), int32 accumulation converted to f32. The page scale
//   multiplies each similarity before the max; the query scale rides in
//   qw, after it.
// - evdr_maxsim_int8: bf16 queries x codes widened to bf16 in shared
//   memory (exact), bf16 tensor cores (m16n8k16) with f32 accumulation.
// A scale is read only for a valid token (pmask); an invalid token is the
// -1 sentinel of pallas_maxsim.py:650-654, and a valid token with scale 0
// scores 0 and still takes part in the max.
//
// What bounds it on the H100: operations (int8: 1,979 TOP/s dense; the
// bf16 form 989 TFLOP/s) at the serving shape, where each code byte meets
// all 8192 query-token rows (16384 operations per byte). The int8 index
// halves the bytes against bf16, which matters only once the kernel runs
// near the tensor-core rate; this version uses mma.sync with a two-buffer
// cp.async page pipeline, not yet wgmma or TMA.
//
// C interface: q (nq, lq, d) int8 or bf16, qw (nq, lq) f32, p (nd, lp, d)
// int8, scales (nd, lp) f32, pmask (nd, lp) bool as bytes, out (nq, nd)
// f32. Returns cudaGetLastError() after the launch.
#include "maxsim_tile.cuh"

extern "C" int evdr_maxsim_int8full(const void* q, const void* qw,
                                    const void* p, const void* scales,
                                    const void* pmask, void* out, int nq,
                                    int lq, int nd, int lp, int d,
                                    void* stream) {
  return evdr::launch<evdr::kInt8Int8>(q, qw, p, scales, pmask, out, nullptr,
                                       nq, lq, nd, lp, d, stream);
}

extern "C" int evdr_maxsim_int8(const void* q, const void* qw, const void* p,
                                const void* scales, const void* pmask,
                                void* out, int nq, int lq, int nd, int lp,
                                int d, void* stream) {
  return evdr::launch<evdr::kInt8Bf16>(q, qw, p, scales, pmask, out, nullptr,
                                       nq, lq, nd, lp, d, stream);
}
