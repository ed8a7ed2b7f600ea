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
// What bounds it on the H100: operations (int8: 1,979 TOP/s dense, of
// which mma.sync s8 reaches ~1,275 on the card; the bf16 form 989 TFLOP/s,
// mma.sync ~634) at the serving shape, where each code byte meets all 8192
// query-token rows (16384 operations per byte). The int8 index halves the
// bytes against bf16, which matters only once the kernel runs near the
// tensor-core rate. The design: mma.sync from ldmatrix with a two-buffer
// cp.async page pipeline (not yet wgmma or TMA), on the tile loop's wide
// configuration (maxsim_tile.cuh CfgWide): 256 query rows x 64 page tokens
// a CTA, 64 x 32 outputs a warp, which halves the ldmatrix bytes per
// product against 32 x 32 and widens each page tile once per 256 rows
// instead of 128; 8 docs a CTA; the bare launch bound (ptxas then keeps
// 128 registers, two CTAs per SM). Measured on an H100 in one call
// against the 128-row layout (PERF.md): 18-19% faster, the same scores
// bit for bit; a minimum of 1 CTA per SM (148-151 registers) ran 52%
// slower, and widening each warp's fragments in registers 7% slower than
// the shared pass.
//
// C interface: q (nq, lq, d) int8 or bf16, qw (nq, lq) f32, p (nd, lp, d)
// int8, scales (nd, lp) f32, pmask (nd, lp) bool as bytes, out (nq, nd)
// f32. Returns cudaGetLastError() after the launch.
#include "maxsim_tile.cuh"
#include "maxsim_wide.cuh"

extern "C" int evdr_maxsim_int8full(const void* q, const void* qw,
                                    const void* p, const void* scales,
                                    const void* pmask, void* out, int nq,
                                    int lq, int nd, int lp, int d,
                                    void* stream) {
  return evdr::launch<evdr::kInt8Int8, false, evdr::CfgWide>(
      q, qw, p, scales, pmask, out, nq, lq, nd, lp, d, stream);
}

extern "C" int evdr_maxsim_int8(const void* q, const void* qw, const void* p,
                                const void* scales, const void* pmask,
                                void* out, int nq, int lq, int nd, int lp,
                                int d, void* stream) {
  return evdr::launch<evdr::kInt8Bf16, false, evdr::CfgWide>(
      q, qw, p, scales, pmask, out, nq, lq, nd, lp, d, stream);
}

// K2's wide path (D above 256): maxsim_wide.cuh's D-chunked loop in
// the same two modes (int32 sums scaled after the max; codes widened to
// bf16 chunk by chunk). C interfaces as above.
extern "C" int evdr_maxsim_int8full_wide(const void* q, const void* qw,
                                         const void* p, const void* scales,
                                         const void* pmask, void* out, int nq,
                                         int lq, int nd, int lp, int d,
                                         void* stream) {
  return evdr::launch_wide<evdr::kInt8Int8, false, false, evdr::kNoBooks>(
      q, qw, p, scales, pmask, out, nullptr, nullptr, nq, lq, nd, lp, d, 0,
      stream);
}

extern "C" int evdr_maxsim_int8_wide(const void* q, const void* qw,
                                     const void* p, const void* scales,
                                     const void* pmask, void* out, int nq,
                                     int lq, int nd, int lp, int d,
                                     void* stream) {
  return evdr::launch_wide<evdr::kInt8Bf16, false, false, evdr::kNoBooks>(
      q, qw, p, scales, pmask, out, nullptr, nullptr, nq, lq, nd, lp, d, 0,
      stream);
}
