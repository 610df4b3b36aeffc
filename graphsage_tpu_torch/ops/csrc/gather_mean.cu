// Fused gather + neighbour mean for Hopper (sm_90a), with and without
// per-element dropout, and with each distinct sample loaded once.
//
//   K1: out[b, :] = (1/S) * sum_s feat[idx[b, s], :]   feat [N, F], idx [B, S]
//   K2: out[b, :] = (1/S) * sum_s keep[b,s,:] * scale * feat[idx[b, s], :]
//   K3: out[b, :] = sum_u (count_u / S) * feat[u, :], u the distinct
//       values of idx[b, :] in ascending order, count_u their multiplicity
//
// K1 replaces graphsage_tpu/ops/gather.py::_gather_mean_kernel (the
// drop_rate=0 path of fused_gather_mean); K2 replaces the same kernel
// with drop_rate>0 (_inkernel_dropout); K3 replaces
// _gather_mean_dedup_kernel together with the dedup_compact it is fed
// (fused_gather_mean(dedup=True)). The [B*S, F] gather and the mask are
// never written to device memory, only the [B, F] f32 mean.
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
// K2's random bits: the TPU kernel reseeds its on-chip generator per
// grid step, which relies on the grid running in order. Hopper's blocks
// run in no order, so K2 uses a counter-based generator instead,
// Philox4x32-10 (Random123), keyed by a 64-bit seed, with the element
// group's 64-bit index in two counter words and (step, tag) in the other
// two. Every element's bits are a pure function of its position, which
// graphsage_tpu_torch/ops/philox.py defines and computes the same way:
//   row r = b*S + s, group g = r*ceil(F/4) + f/4, word f%4 of
//   philox(g lo, g hi, step, tag; seed lo, seed hi); kept iff word < t.
// Seed, step and tag arrive by value, so nothing is read back per step.
//
// What bounds K2: operations, not bytes. Its bytes are K1's, but one
// Philox call per four elements costs 10 rounds of two 32x32->64
// multiplies and two three-input XORs (the key schedule is the same
// for every thread), about 10 integer instructions per element plus the
// compare: at the serving hop shape (77M elements) that is of order
// 0.05 ms at the H100's int32 rate, above the ~0.02 ms bytes bound.
// Design (simple and correct first): K1's block-per-row layout; each
// thread owns chunks of W = max(4, VEC) columns, i.e. whole Philox
// groups, so each call's four words serve four elements; the chunk is
// loaded VEC elements at a time (VEC divides F, so a vector is all in
// or all out of the row; a row's last chunk may be partial). Left to a
// later PR: fewer rounds or fewer bits per element, and overlapping the
// generator with the row loads.
//
// What bounds K3: memory bytes, as K1. It reads each distinct row once
// (K1's bound already counts only distinct rows), the [B, F] f32 output
// and the idx: at the serving hop (idx [5120, 25] from the sampler, F
// 602 f32, ~13.4k distinct rows, 21.7 of 25 distinct per output row)
// 0.0135 ms at 3.35 TB/s. What it saves over K1 is the L2 and load
// traffic of repeated samples within one output row.
// Design (simple and correct first): K1's block-per-row layout; the
// compaction that the TPU kernel takes from dedup_compact in XLA runs
// inside the block, so the wrapper launches one kernel and nothing
// else: the S samples go to shared memory; each thread counts one
// sample's multiplicity and whether it is the value's first occurrence
// (O(S^2) compares, 625 at S = 25); the first occurrences are ranked by
// value, so the distinct samples and their weights count/S are
// compacted in ascending order, as dedup_compact orders them, and every
// run sums in the same order. Then the threads stride over the F
// columns with K1's vector loads and accumulate w_u * row_u over the
// n_u distinct rows in f32. No tail slot is ever loaded, so none needs
// zeroing. Shared memory: four 4-byte words per sample, so S <= 3072
// within the 48 KB a block gets without opting in (MAX_DEDUP_SAMPLES).
// Left to a later PR: a sort in place of the O(S^2) ranking for large S,
// and deduplication across rows (hub rows shared by many output rows).
//
// Plain C interface for ctypes; each entry point returns
// cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace {

using graphsage::philox_group;
using graphsage::to_float;

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
__global__ void gather_mean_dropout_kernel(
    const T* __restrict__ feat, const int32_t* __restrict__ idx,
    float* __restrict__ out, int64_t n_rows, int S, int F, float inv_s,
    uint32_t seed_lo, uint32_t seed_hi, uint32_t step, uint32_t tag,
    uint32_t threshold, float scale) {
  constexpr int W = VEC > 4 ? VEC : 4;  // columns per chunk: whole groups
  extern __shared__ int64_t row_off[];
  const int64_t b = blockIdx.x;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const int64_t r = idx[b * S + s];
    if (r < 0 || r >= n_rows) __trap();
    row_off[s] = r * F;
  }
  __syncthreads();

  const int n_chunks = (F + W - 1) / W;
  const int64_t groups_per_row = (F + 3) / 4;
  float* out_row = out + b * F;
  for (int c = threadIdx.x; c < n_chunks; c += blockDim.x) {
    const int col0 = c * W;
    float acc[W];
#pragma unroll
    for (int k = 0; k < W; ++k) acc[k] = 0.f;
    for (int s = 0; s < S; ++s) {
      const int64_t g0 = (b * S + s) * groups_per_row + col0 / 4;
      uint32_t bits[W];
#pragma unroll
      for (int q = 0; q < W / 4; ++q) {
        const uint4 r = philox_group(static_cast<uint64_t>(g0 + q), step,
                                     tag, seed_lo, seed_hi);
        bits[4 * q] = r.x;
        bits[4 * q + 1] = r.y;
        bits[4 * q + 2] = r.z;
        bits[4 * q + 3] = r.w;
      }
#pragma unroll
      for (int j = 0; j < W / VEC; ++j) {
        const int col = col0 + j * VEC;
        if (col < F) {
          const Vec<T, VEC> x =
              *reinterpret_cast<const Vec<T, VEC>*>(feat + row_off[s] + col);
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            const float v = to_float(x.v[k]) * scale;
            acc[j * VEC + k] += bits[j * VEC + k] < threshold ? v : 0.f;
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < W / VEC; ++j) {
      const int col = col0 + j * VEC;
      if (col < F) {
        Vec<float, VEC> y;
#pragma unroll
        for (int k = 0; k < VEC; ++k) y.v[k] = acc[j * VEC + k] * inv_s;
        *reinterpret_cast<Vec<float, VEC>*>(out_row + col) = y;
      }
    }
  }
}

// K3. Dynamic shared memory: sample[S], mult[S] (the multiplicity at a
// value's first occurrence, else 0), uniq[S] (the distinct samples,
// ascending), w[S] (their multiplicity / S).
template <typename T, int VEC>
__global__ void gather_mean_dedup_kernel(const T* __restrict__ feat,
                                         const int32_t* __restrict__ idx,
                                         float* __restrict__ out,
                                         int64_t n_rows, int S, int F) {
  extern __shared__ int32_t dedup_smem[];
  int32_t* sample = dedup_smem;
  int32_t* mult = sample + S;
  int32_t* uniq = mult + S;
  float* w = reinterpret_cast<float*>(uniq + S);
  const int64_t b = blockIdx.x;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const int32_t r = idx[b * S + s];
    if (r < 0 || r >= n_rows) __trap();
    sample[s] = r;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const int32_t v = sample[s];
    int count = 0;
    bool first = true;
    for (int t = 0; t < S; ++t) {
      if (sample[t] == v) {
        ++count;
        first = first && t >= s;
      }
    }
    mult[s] = first ? count : 0;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    if (mult[s] == 0) continue;
    const int32_t v = sample[s];
    int rank = 0;
    for (int t = 0; t < S; ++t) rank += (mult[t] != 0 && sample[t] < v);
    uniq[rank] = v;
    w[rank] = static_cast<float>(mult[s]) / static_cast<float>(S);
  }
  __syncthreads();
  int n_u = 0;
  for (int t = 0; t < S; ++t) n_u += mult[t] != 0;

  const int n_vec = F / VEC;
  float* out_row = out + b * F;
  for (int c = threadIdx.x; c < n_vec; c += blockDim.x) {
    const int64_t col = static_cast<int64_t>(c) * VEC;
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
    for (int u = 0; u < n_u; ++u) {
      const float wu = w[u];
      const Vec<T, VEC> x = *reinterpret_cast<const Vec<T, VEC>*>(
          feat + static_cast<int64_t>(uniq[u]) * F + col);
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] += wu * to_float(x.v[k]);
    }
    Vec<float, VEC> y;
#pragma unroll
    for (int k = 0; k < VEC; ++k) y.v[k] = acc[k];
    *reinterpret_cast<Vec<float, VEC>*>(out_row + col) = y;
  }
}

int block_threads(int work_items) {
  int threads = (work_items + 31) / 32 * 32;
  return threads > 1024 ? 1024 : threads;
}

template <typename T, int VEC>
int launch(const void* feat, const void* idx, void* out, long long n_rows,
           int B, int S, int F, void* stream) {
  const size_t smem = static_cast<size_t>(S) * sizeof(int64_t);
  gather_mean_kernel<T, VEC>
      <<<B, block_threads(F / VEC), smem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(feat), static_cast<const int32_t*>(idx),
          static_cast<float*>(out), n_rows, S, F, 1.0f / S);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int launch_dropout(const void* feat, const void* idx, void* out,
                   long long n_rows, int B, int S, int F,
                   unsigned long long seed, unsigned int step,
                   unsigned int tag, unsigned int threshold, float scale,
                   void* stream) {
  constexpr int W = VEC > 4 ? VEC : 4;
  const size_t smem = static_cast<size_t>(S) * sizeof(int64_t);
  gather_mean_dropout_kernel<T, VEC>
      <<<B, block_threads((F + W - 1) / W), smem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(feat), static_cast<const int32_t*>(idx),
          static_cast<float*>(out), n_rows, S, F, 1.0f / S,
          static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32),
          step, tag, threshold, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int launch_dedup(const void* feat, const void* idx, void* out,
                 long long n_rows, int B, int S, int F, void* stream) {
  const size_t smem = static_cast<size_t>(S) * 4 * sizeof(int32_t);
  gather_mean_dedup_kernel<T, VEC>
      <<<B, block_threads(F / VEC), smem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(feat), static_cast<const int32_t*>(idx),
          static_cast<float*>(out), n_rows, S, F);
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

// K2: as above, plus the generator's seed, the (step, tag) counter
// words, the keep threshold and the 1/keep scale.
#define GRAPHSAGE_DROPOUT_ARGS                                              \
  feat, idx, out, n_rows, B, S, F, seed, step, tag, threshold, scale, stream

int graphsage_gather_mean_dropout_f32(
    const void* feat, const void* idx, void* out, long long n_rows, int B,
    int S, int F, int vec, unsigned long long seed, unsigned int step,
    unsigned int tag, unsigned int threshold, float scale, void* stream) {
  switch (vec) {
    case 1: return launch_dropout<float, 1>(GRAPHSAGE_DROPOUT_ARGS);
    case 2: return launch_dropout<float, 2>(GRAPHSAGE_DROPOUT_ARGS);
    case 4: return launch_dropout<float, 4>(GRAPHSAGE_DROPOUT_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int graphsage_gather_mean_dropout_bf16(
    const void* feat, const void* idx, void* out, long long n_rows, int B,
    int S, int F, int vec, unsigned long long seed, unsigned int step,
    unsigned int tag, unsigned int threshold, float scale, void* stream) {
  switch (vec) {
    case 1: return launch_dropout<__nv_bfloat16, 1>(GRAPHSAGE_DROPOUT_ARGS);
    case 2: return launch_dropout<__nv_bfloat16, 2>(GRAPHSAGE_DROPOUT_ARGS);
    case 4: return launch_dropout<__nv_bfloat16, 4>(GRAPHSAGE_DROPOUT_ARGS);
    case 8: return launch_dropout<__nv_bfloat16, 8>(GRAPHSAGE_DROPOUT_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#undef GRAPHSAGE_DROPOUT_ARGS

// K3: K1's arguments; S at most 3072 (four shared 4-byte words a sample).
int graphsage_gather_mean_dedup_f32(const void* feat, const void* idx,
                                    void* out, long long n_rows, int B,
                                    int S, int F, int vec, void* stream) {
  switch (vec) {
    case 1:
      return launch_dedup<float, 1>(feat, idx, out, n_rows, B, S, F, stream);
    case 2:
      return launch_dedup<float, 2>(feat, idx, out, n_rows, B, S, F, stream);
    case 4:
      return launch_dedup<float, 4>(feat, idx, out, n_rows, B, S, F, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int graphsage_gather_mean_dedup_bf16(const void* feat, const void* idx,
                                     void* out, long long n_rows, int B,
                                     int S, int F, int vec, void* stream) {
  switch (vec) {
    case 1:
      return launch_dedup<__nv_bfloat16, 1>(feat, idx, out, n_rows, B, S, F,
                                            stream);
    case 2:
      return launch_dedup<__nv_bfloat16, 2>(feat, idx, out, n_rows, B, S, F,
                                            stream);
    case 4:
      return launch_dedup<__nv_bfloat16, 4>(feat, idx, out, n_rows, B, S, F,
                                            stream);
    case 8:
      return launch_dedup<__nv_bfloat16, 8>(feat, idx, out, n_rows, B, S, F,
                                            stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* graphsage_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
