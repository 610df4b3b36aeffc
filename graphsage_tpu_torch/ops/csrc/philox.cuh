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

// (hi, lo) of the 64-bit product a * b: one mul.wide.u32 (IMAD.WIDE.U32)
// where the high and low halves taken apart would be two multiplies
__device__ __forceinline__ uint2 mulhilo(uint32_t a, uint32_t b) {
  const uint64_t p = static_cast<uint64_t>(a) * b;
  return make_uint2(static_cast<uint32_t>(p >> 32), static_cast<uint32_t>(p));
}

// The ten round keys of each key word, k + i*W: the same for every thread
// of a launch. Passed to a kernel by value, they stay in its parameter
// bank, each round's two XORs of three words one LOP3 each with the key
// as the bank operand: no registers and no adds for the key schedule.
struct PhiloxKeys {
  uint32_t k0[10];
  uint32_t k1[10];
};

__host__ __device__ inline PhiloxKeys philox_keys(uint32_t k0, uint32_t k1) {
  PhiloxKeys keys;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    keys.k0[i] = k0 + i * kPhiloxW0;
    keys.k1[i] = k1 + i * kPhiloxW1;
  }
  return keys;
}

// N independent Philox4x32-10 calls, round by round: the N chains'
// multiplies interleave, so that a warp has N of them in flight.
template <int N>
__device__ __forceinline__ void philox4x32_10(uint4 (&c)[N],
                                              const PhiloxKeys& keys) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const uint2 p0 = mulhilo(kPhiloxM0, c[n].x);
      const uint2 p1 = mulhilo(kPhiloxM1, c[n].z);
      c[n] = make_uint4(p1.x ^ c[n].y ^ keys.k0[i], p1.y,
                        p0.x ^ c[n].w ^ keys.k1[i], p0.y);
    }
  }
}

// The four words of element group g (64-bit) of one (step, tag) stream,
// one call with its round keys computed in place (the compiler computes
// them once, outside the callers' loops): K6's draw, which measured 1.3%
// slower through philox4x32_10<1> and philox_keys.
__device__ __forceinline__ uint4 philox_group(uint64_t g, uint32_t step,
                                              uint32_t tag, uint32_t seed_lo,
                                              uint32_t seed_hi) {
  uint4 c = make_uint4(static_cast<uint32_t>(g),
                       static_cast<uint32_t>(g >> 32), step, tag);
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint2 p0 = mulhilo(kPhiloxM0, c.x);
    const uint2 p1 = mulhilo(kPhiloxM1, c.z);
    c = make_uint4(p1.x ^ c.y ^ (seed_lo + i * kPhiloxW0), p1.y,
                   p0.x ^ c.w ^ (seed_hi + i * kPhiloxW1), p0.y);
  }
  return c;
}

}  // namespace graphsage
