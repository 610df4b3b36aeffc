// Fused gather + neighbour mean for Hopper (sm_90a).
//
//   out[b, :] = (1/S) * sum_s feat[idx[b, s], :]      feat [N, F], idx [B, S]
//
// Replaces graphsage_tpu/ops/gather.py::_gather_mean_kernel (the
// drop_rate=0 path of fused_gather_mean): the [B*S, F] gather is never
// written to device memory, only the [B, F] f32 mean.
//
// What bounds it on the H100: memory bytes. Counting each distinct
// gathered row once (repeats of a zipf hub row come from L2), plus the
// [B, F] f32 output and the idx, the serving hop (idx [5120, 25] into a
// [100001, 602] f32 table) moves tens of MB for ~77M adds, far below
// the card's operation rate.
//
// Design (a simple, correct first version):
//   * one block per output row; the row's S indices are loaded once
//     into shared memory as 64-bit element offsets (idx * F overflows
//     int32 beyond ~3.5M rows at F = 602);
//   * threads stride over the F columns in vectors of VEC elements,
//     neighbouring threads on neighbouring addresses, and accumulate in
//     f32 registers. VEC is the widest load (up to 16 bytes) that divides
//     F and the table's alignment, so every row start stays aligned and
//     there is no tail (F = 602 f32 rows, 2408 bytes, load as float2);
//   * the table is f32 or bf16; the output is always f32;
//   * an out-of-range index traps, as PyTorch's own index kernels do.
// Left to a later PR: keeping zipf hub rows resident (L2 persistence or
// a shared-memory cache), asynchronous copies (cp.async / TMA) to
// overlap the S row loads, and several output rows per block for
// narrow F.
//
// Plain C interface for ctypes; each entry point returns
// cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void gather_mean_kernel(const T* __restrict__ feat,
                                   const int32_t* __restrict__ idx,
                                   float* __restrict__ out, int64_t n_rows,
                                   int S, int F, float inv_s) {
  extern __shared__ int64_t row_off[];
  const int64_t b = blockIdx.x;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const int64_t r = idx[b * S + s];
    if (r < 0 || r >= n_rows) __trap();
    row_off[s] = r * F;
  }
  __syncthreads();

  const int n_vec = F / VEC;
  float* out_row = out + b * F;
  for (int c = threadIdx.x; c < n_vec; c += blockDim.x) {
    const int64_t col = static_cast<int64_t>(c) * VEC;
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
#pragma unroll 5
    for (int s = 0; s < S; ++s) {
      const Vec<T, VEC> x =
          *reinterpret_cast<const Vec<T, VEC>*>(feat + row_off[s] + col);
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] += to_float(x.v[k]);
    }
    Vec<float, VEC> y;
#pragma unroll
    for (int k = 0; k < VEC; ++k) y.v[k] = acc[k] * inv_s;
    *reinterpret_cast<Vec<float, VEC>*>(out_row + col) = y;
  }
}

template <typename T, int VEC>
int launch(const void* feat, const void* idx, void* out, long long n_rows,
           int B, int S, int F, void* stream) {
  const int n_vec = F / VEC;
  int threads = (n_vec + 31) / 32 * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem = static_cast<size_t>(S) * sizeof(int64_t);
  gather_mean_kernel<T, VEC>
      <<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(feat), static_cast<const int32_t*>(idx),
          static_cast<float*>(out), n_rows, S, F, 1.0f / S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// vec: elements per load, 1, 2 or 4 (f32) and also 8 (bf16).
int graphsage_gather_mean_f32(const void* feat, const void* idx, void* out,
                              long long n_rows, int B, int S, int F, int vec,
                              void* stream) {
  switch (vec) {
    case 1: return launch<float, 1>(feat, idx, out, n_rows, B, S, F, stream);
    case 2: return launch<float, 2>(feat, idx, out, n_rows, B, S, F, stream);
    case 4: return launch<float, 4>(feat, idx, out, n_rows, B, S, F, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int graphsage_gather_mean_bf16(const void* feat, const void* idx, void* out,
                               long long n_rows, int B, int S, int F, int vec,
                               void* stream) {
  switch (vec) {
    case 1:
      return launch<__nv_bfloat16, 1>(feat, idx, out, n_rows, B, S, F, stream);
    case 2:
      return launch<__nv_bfloat16, 2>(feat, idx, out, n_rows, B, S, F, stream);
    case 4:
      return launch<__nv_bfloat16, 4>(feat, idx, out, n_rows, B, S, F, stream);
    case 8:
      return launch<__nv_bfloat16, 8>(feat, idx, out, n_rows, B, S, F, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* graphsage_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
