// K1 in float32 mode: fused masked MaxSim at (near) float32 precision, for
// Hopper (sm_90a).
//
// Replaces: evdr_tpu/ops/pallas_maxsim.py:_kernel run with
// compute_dtype=float32 (Precision.HIGHEST, pallas_maxsim.py:552-553), the
// scorer of every metric the trainer reports (eval, teacher precompute).
//
// Hopper's tensor cores have no exact-f32 product, so each product is
// split into TF32 halves (3xTF32, see mma() in maxsim_tile.cuh): three
// mma.sync m16n8k8 tf32 instructions per k-step, f32 accumulation, only
// the lo x lo term (~2^-22 relative) dropped. The tile loop is K1's (a CTA
// of 128 whole-query rows walks its docs' Lp tiles, the masked running max
// stays in registers, cp.async double-buffers the page tiles, the -1e30
// fill and -1e29 no-valid-token rule are kept); only the operand width
// (16-byte units of 4 floats) and the MMA differ.
//
// What bounds it on the H100: operations. It runs at the TF32 tensor-core
// rate (495 TFLOP/s dense) with three products per element, so at best a
// third of that on the function's 2 * D operations per token pair; f32
// operands also double the shared-memory bytes per tile against bf16.
// At D <= 192 the query block and two page tiles fit in shared memory.
//
// C interface (ctypes; every pointer and the stream is a void*): q
// (nq, lq, d) f32, qw (nq, lq) f32 query-token weights, p (nd, lp, d) f32,
// pmask (nd, lp) bool as bytes, out (nq, nd) f32. Returns
// cudaGetLastError() after the launch.
#include "maxsim_tile.cuh"

extern "C" int evdr_maxsim_f32(const void* q, const void* qw, const void* p,
                               const void* pmask, void* out, int nq, int lq,
                               int nd, int lp, int d, void* stream) {
  return evdr::launch<evdr::kF32>(q, qw, p, nullptr, pmask, out, nullptr, nq,
                                  lq, nd, lp, d, stream);
}
