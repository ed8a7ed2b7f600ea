// K4: fused masked MaxSim over a token-pair packed int4 page index
// (per-token f32 scales), for Hopper (sm_90a).
//
// Replaces: evdr_tpu/ops/pallas_maxsim.py:_kernel_int4 with _int4_blockmax
// (host side _maxsim_int4_impl, public entries maxsim_pallas_int4full and
// maxsim_pallas_int4).
//
// Byte [n, t, d] of the index holds dim d of token 2t in its low nibble and
// of token 2t + 1 in its high nibble, two's complement, codes in [-8, 7]
// (the quantizer writes +-7). Two entry points share K2's tile loop
// (maxsim_tile.cuh):
// - evdr_maxsim_int4full: int8 queries (quantized per token on the device
//   before the launch) x codes unpacked to int8, mma.sync m16n8k32 s8 with
//   int32 accumulation; the query scale rides in qw, after the max.
// - evdr_maxsim_int4: bf16 queries x codes unpacked to bf16 (exact),
//   mma.sync m16n8k16 with f32 accumulation.
// The page scale multiplies each similarity before the max. A scale is read
// only for a valid token (pmask): an invalid token, and an odd Lp's pad
// nibble (which has no scale entry), is the -1 sentinel; a valid token of
// scale 0 scores 0 and takes part in the max, as in K2.
//
// What bounds it on the H100: operations, as K2 (each code byte meets all
// 8192 query-token rows of the serving batch). The design streams half of
// K2's bytes: cp.async brings the packed tile (32 rows of D bytes for 64
// tokens) into a double-buffered raw area, and once it lands the threads
// unpack both nibble planes into the MMA operand tile in shared memory
// (per-byte sign extension by __vsub4), in token order; K2's mma.sync loop
// and register-held running max follow unchanged, on K2's wide tile
// configuration (256 x 64 a CTA, 64 x 32 outputs a warp, 8 docs a CTA:
// 18-20% faster than 128 rows on an H100, the same scores bit for bit,
// PERF.md).
// Unpacking in registers instead (ldmatrix of the packed rows: one load
// gives a thread dims 4t .. 4t + 3 of an even and an odd token) tied in
// int4full mode and ran 18% slower in int4 mode, where each warp widens to
// bf16. The TPU kernel's even/odd-plane split is a VMEM layout device and
// is not needed here. PTX's s4 mma shapes would need 4-bit queries, which
// would change the result, so the codes widen to the queries' type
// instead.
//
// C interface: q (nq, lq, d) int8 or bf16, qw (nq, lq) f32, p (nd,
// ceil(lp / 2), d) uint8, scales (nd, lp) f32, pmask (nd, lp) bool as
// bytes, out (nq, nd) f32. Returns cudaGetLastError() after the launch.
#include "maxsim_tile.cuh"
#include "maxsim_wide.cuh"

extern "C" int evdr_maxsim_int4full(const void* q, const void* qw,
                                    const void* p, const void* scales,
                                    const void* pmask, void* out, int nq,
                                    int lq, int nd, int lp, int d,
                                    void* stream) {
  return evdr::launch<evdr::kInt4Int8, false, evdr::CfgWide>(
      q, qw, p, scales, pmask, out, nq, lq, nd, lp, d, stream);
}

extern "C" int evdr_maxsim_int4(const void* q, const void* qw, const void* p,
                                const void* scales, const void* pmask,
                                void* out, int nq, int lq, int nd, int lp,
                                int d, void* stream) {
  return evdr::launch<evdr::kInt4Bf16, false, evdr::CfgWide>(
      q, qw, p, scales, pmask, out, nq, lq, nd, lp, d, stream);
}

// K4's wide path (D above 256): maxsim_wide.cuh's D-chunked loop in
// the same two modes, each packed chunk unpacked in shared memory. C interfaces as above.
extern "C" int evdr_maxsim_int4full_wide(const void* q, const void* qw,
                                         const void* p, const void* scales,
                                         const void* pmask, void* out, int nq,
                                         int lq, int nd, int lp, int d,
                                         void* stream) {
  return evdr::launch_wide<evdr::kInt4Int8, false, false, evdr::kNoBooks>(
      q, qw, p, scales, pmask, out, nullptr, nullptr, nq, lq, nd, lp, d, 0,
      stream);
}

extern "C" int evdr_maxsim_int4_wide(const void* q, const void* qw,
                                     const void* p, const void* scales,
                                     const void* pmask, void* out, int nq,
                                     int lq, int nd, int lp, int d,
                                     void* stream) {
  return evdr::launch_wide<evdr::kInt4Bf16, false, false, evdr::kNoBooks>(
      q, qw, p, scales, pmask, out, nullptr, nullptr, nq, lq, nd, lp, d, 0,
      stream);
}
