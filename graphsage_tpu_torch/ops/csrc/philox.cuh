// Device helpers shared by the port's kernels: the table element's
// upcast to f32, and Random123's Philox4x32-10, the generator of the
// in-kernel dropout masks (K2 in gather_mean.cu, K5/K6 in
// gather_mlp_pool.cu). graphsage_tpu_torch/ops/philox.py computes the
// same bits in plain PyTorch and defines which element gets which word.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace graphsage {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const uint32_t lo0 = kPhiloxM0 * c.x;
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x);
    const uint32_t lo1 = kPhiloxM1 * c.z;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// The four words of element group g (64-bit) of one (step, tag) stream.
__device__ __forceinline__ uint4 philox_group(uint64_t g, uint32_t step,
                                              uint32_t tag, uint32_t seed_lo,
                                              uint32_t seed_hi) {
  return philox4x32_10(make_uint4(static_cast<uint32_t>(g),
                                  static_cast<uint32_t>(g >> 32), step, tag),
                       seed_lo, seed_hi);
}

}  // namespace graphsage
