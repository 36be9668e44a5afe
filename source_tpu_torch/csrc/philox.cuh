// Philox4x32-10, the counter-based generator of the span kernels' in-kernel
// RNG (Salmon, Moraes, Dror and Shaw, "Parallel random numbers: as easy as
// 1, 2, 3", SC 2011; the constants are the published ones). Written by hand:
// no cuRAND and none of its headers.
//
// It replaces the TPU's hardware generator of the JAX package's span kernels
// (source_tpu/tracer/pallas_fused.py, _gen_u, drawn by _span_fwd_kernel and
// _span_bwd_kernel when SOURCE_TPU_RNG=kernel). It keeps what _gen_u
// guarantees: one stream per (seed, lane, bounce) whatever the block size,
// so the forward kernel, the adjoint's replay and the plain version
// (tracer/fused.py philox_uniforms, the same function in torch integer ops)
// draw the same uniforms. The counter is (lane index in the batch, absolute
// bounce index, draw 0..2, 0) and the key the span's two seed words: never
// blockIdx or threadIdx.
//
// Cost: three calls give the bounce's 10 uniforms (12 words, the last two
// unused), about 300 integer operations a ray and a bounce, against the 40
// bytes of uniforms a ray and a bounce the host-RNG branch reads.
#pragma once

#include <cstdint>

namespace fb {

struct U32x4 {
  uint32_t x, y, z, w;
};

__device__ __forceinline__ U32x4 philox4x32_10(U32x4 c, uint32_t k0,
                                               uint32_t k1) {
  constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;  // multipliers
  constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;  // Weyl increments
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += W0;
      k1 += W1;
    }
    uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = U32x4{hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0};
  }
  return c;
}

// A 32-bit word as a uniform in [0, 1 - 2^-24]: its top 24 bits times 2^-24,
// exact in f32 (as _gen_u converts).
__device__ __forceinline__ float word_to_uniform(uint32_t w) {
  return (float)(w >> 8) * 5.9604644775390625e-08f;
}

// The 10 uniforms of ray ``lane`` at absolute bounce index ``bounce`` under
// the key (k0, k1).
__device__ __forceinline__ void philox_uniforms(uint32_t lane, uint32_t bounce,
                                                uint32_t k0, uint32_t k1,
                                                float* u) {
#pragma unroll
  for (uint32_t j = 0; j < 3; ++j) {
    U32x4 w = philox4x32_10(U32x4{lane, bounce, j, 0u}, k0, k1);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (4 * j + k < 10) u[4 * j + k] = word_to_uniform(words[k]);
  }
}

}  // namespace fb
