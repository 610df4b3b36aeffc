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
// What bounds K1 and K3 on the H100: memory bytes. Each distinct
// gathered row once, the [B, F] f32 output and the idx: at the serving
// hop (idx [5120, 25] from the sampler's shared_perm over the zipf
// adjacency, into a [100001, 602] f32 table; ~13.4k distinct rows) that
// is ~45 MB, 0.0134 ms at 3.35 TB/s, for ~77M adds, far below the
// card's operation rate. What sets their pace is the SM's load path,
// not device memory: every (row, sample) pulls its 2,408 bytes through
// L1 in 8-byte loads (F = 602 f32 rows start 8 bytes off a 16-byte
// boundary at odd ids), 308 MB a launch; the same launch on an
// L2-resident idx takes as long, and a gather whose every load hits L1
// still takes two thirds of it (chip_smoke.py --loads measures both).
//
// Design: one block per output row, a thread per VEC columns (the
// widest load, up to 16 bytes, that divides F and the table's
// alignment), f32 accumulators in registers, at most 512 threads a
// block striding over the row's vectors.
//   * K1: the row's S samples, their 64-bit row offsets in shared
//     memory (idx * F overflows int32 beyond ~3.5M rows at F = 602),
//     summed in order through the read-only path, 5 loads in flight a
//     thread, then scaled by 1/S;
//   * K3: the row's distinct samples are ranked in shared memory (a flag
//     at each first occurrence, then each one's ascending rank and its
//     count, every thread reading the same sample at once, a broadcast),
//     so the distinct rows and their weights count/S come out in
//     ascending order, as dedup_compact orders them; each distinct row
//     is loaded once and added with its weight, 4 loads in flight;
//   * an id outside [0, N) traps, as PyTorch's own index kernels do;
//     the table is f32 or bf16, the output f32; no float atomics, so
//     two launches are bit-identical.
// Rows shared across output rows are not loaded once a block: tiles of
// 2-8 rows that load each distinct row of the tile once and add it into
// every row that holds it, shared-memory stages of a tile's distinct
// rows, and a warp-level rank (__match_any_sync) all measured slower on
// this card (PERF.md, section 6): each row a tile adds costs a fused
// multiply-add a load and lengthens each thread's chain of loads, and
// finding the shared rows costs more than re-reading them through L1.
// chip_smoke.py --loads times K1 and K3 at each load width and on ids
// that isolate the load path's parts.
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
// Design (simple and correct first): one block per output row, its S
// row offsets in shared memory as 64-bit element offsets (idx * F
// overflows int32 beyond ~3.5M rows at F = 602); each thread owns
// chunks of W = max(4, VEC) columns, i.e. whole Philox groups, so each
// call's four words serve four elements; the chunk is loaded VEC
// elements at a time (VEC, the widest load up to 16 bytes that divides
// F and the table's alignment, so a vector is all in or all out of the
// row; a row's last chunk may be partial), accumulated in f32 registers.
// Left to a later PR: fewer rounds or fewer bits per element, and
// overlapping the generator with the row loads.
//
// The table is f32 or bf16; the output is always f32. Plain C
// interface for ctypes; each entry point returns cudaGetLastError()
// after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "philox.cuh"

namespace {

using graphsage::philox_group;
using graphsage::to_float;

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

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

int block_threads(int work_items) {
  int threads = (work_items + 31) / 32 * 32;
  return threads > 1024 ? 1024 : threads;
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

// ------------------------------------------------------------- K1 and K3

constexpr int kMaxThreads = 512;  // at most 128 registers a thread

// VEC elements of the table at p, through the read-only data path.
template <typename T, int VEC>
__device__ __forceinline__ Vec<T, VEC> ldg_vec(const T* p) {
  constexpr int kBytes = sizeof(T) * VEC;
  using Raw = std::conditional_t<
      kBytes == 16, uint4,
      std::conditional_t<kBytes == 8, uint2,
                         std::conditional_t<kBytes == 4, unsigned int,
                                            unsigned short>>>;
  Vec<T, VEC> x;
  *reinterpret_cast<Raw*>(&x) = __ldg(reinterpret_cast<const Raw*>(p));
  return x;
}

// Shared memory bytes: K1 keeps the samples' row offsets; K3 the
// distinct rows' offsets, and the samples, a flag at each first
// occurrence, the distinct rows' weights and their count.
template <bool DEDUP>
size_t smem_bytes(int S) {
  return static_cast<size_t>(S) * (DEDUP ? 20 : 8) + (DEDUP ? 4 : 0);
}

// K1 (DEDUP false) and K3 (DEDUP true): one block per output row.
template <typename T, int VEC, bool DEDUP>
__global__ void __launch_bounds__(kMaxThreads)
    gather_mean_kernel(const T* __restrict__ feat,
                       const int32_t* __restrict__ idx,
                       float* __restrict__ out, int64_t n_rows, int S,
                       int F) {
  extern __shared__ int64_t row_off[];  // [S]: K1 each sample's, K3 ranked
  int32_t* sample = reinterpret_cast<int32_t*>(row_off + S);  // K3: [S]
  int32_t* first = sample + S;                                // K3: [S]
  float* weight = reinterpret_cast<float*>(first + S);        // K3: [S]
  int* n_distinct = reinterpret_cast<int*>(weight + S);       // K3
  const int64_t b = blockIdx.x;

  // 1. the row's samples (an id outside [0, N) traps)
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const int32_t r = idx[b * S + s];
    if (r < 0 || r >= n_rows) __trap();
    if (DEDUP) {
      sample[s] = r;
    } else {
      row_off[s] = static_cast<int64_t>(r) * F;
    }
  }
  if (DEDUP && threadIdx.x == 0) *n_distinct = 0;
  __syncthreads();

  int n = S;  // the rows summed
  if constexpr (DEDUP) {
    // 2. the distinct samples: first occurrences, then each one's
    // ascending rank among them and its count
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const int32_t v = sample[s];
      int dup = 0;
      for (int j = 0; j < s; ++j) dup |= sample[j] == v;
      first[s] = !dup;
    }
    __syncthreads();
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      if (!first[s]) continue;
      const int32_t v = sample[s];
      int rank = 0;
      int count = 0;
      for (int j = 0; j < S; ++j) {
        rank += first[j] && sample[j] < v;
        count += sample[j] == v;
      }
      row_off[rank] = static_cast<int64_t>(v) * F;
      weight[rank] = static_cast<float>(count) / static_cast<float>(S);
      atomicAdd(n_distinct, 1);
    }
    __syncthreads();
    n = *n_distinct;
  }

  // 3. K1: every sample in order, then 1/S; K3: each distinct row once,
  // in ascending order, with its weight
  float* out_row = out + b * F;
  for (int c = threadIdx.x; c < F / VEC; c += blockDim.x) {
    const int col = c * VEC;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    if constexpr (DEDUP) {
#pragma unroll 4
      for (int u = 0; u < n; ++u) {
        const Vec<T, VEC> x = ldg_vec<T, VEC>(feat + row_off[u] + col);
        const float w = weight[u];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          acc[e] = fmaf(w, to_float(x.v[e]), acc[e]);
        }
      }
    } else {
#pragma unroll 5
      for (int u = 0; u < n; ++u) {
        const Vec<T, VEC> x = ldg_vec<T, VEC>(feat + row_off[u] + col);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] += to_float(x.v[e]);
      }
    }
    const float scale = DEDUP ? 1.f : 1.f / static_cast<float>(S);
    Vec<float, VEC> y;
#pragma unroll
    for (int e = 0; e < VEC; ++e) y.v[e] = acc[e] * scale;
    *reinterpret_cast<Vec<float, VEC>*>(out_row + col) = y;
  }
}

template <typename T, int VEC, bool DEDUP>
int launch(const void* feat, const void* idx, void* out, long long n_rows,
           int B, int S, int F, void* stream) {
  auto kernel = gather_mean_kernel<T, VEC, DEDUP>;
  const size_t smem = smem_bytes<DEDUP>(S);
  if (smem > 48 * 1024) {  // K3 beyond S = 2457 opts in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int threads = block_threads(F / VEC);
  if (threads > kMaxThreads) threads = kMaxThreads;
  kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(feat), static_cast<const int32_t*>(idx),
      static_cast<float*>(out), n_rows, S, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K1 (graphsage_gather_mean_*) and K3 (graphsage_gather_mean_dedup_*).
// vec: elements per load, 1, 2 or 4 (f32) and also 8 (bf16). K1 takes S
// up to 6144, K3 up to 3072 (8 and 20 shared bytes a sample).
#define GRAPHSAGE_MEAN_PARAMS                                             \
  const void *feat, const void *idx, void *out, long long n_rows, int B,  \
      int S, int F, int vec, void *stream
#define GRAPHSAGE_MEAN_ARGS feat, idx, out, n_rows, B, S, F, stream

int graphsage_gather_mean_f32(GRAPHSAGE_MEAN_PARAMS) {
  switch (vec) {
    case 1: return launch<float, 1, false>(GRAPHSAGE_MEAN_ARGS);
    case 2: return launch<float, 2, false>(GRAPHSAGE_MEAN_ARGS);
    case 4: return launch<float, 4, false>(GRAPHSAGE_MEAN_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int graphsage_gather_mean_bf16(GRAPHSAGE_MEAN_PARAMS) {
  switch (vec) {
    case 1: return launch<__nv_bfloat16, 1, false>(GRAPHSAGE_MEAN_ARGS);
    case 2: return launch<__nv_bfloat16, 2, false>(GRAPHSAGE_MEAN_ARGS);
    case 4: return launch<__nv_bfloat16, 4, false>(GRAPHSAGE_MEAN_ARGS);
    case 8: return launch<__nv_bfloat16, 8, false>(GRAPHSAGE_MEAN_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int graphsage_gather_mean_dedup_f32(GRAPHSAGE_MEAN_PARAMS) {
  switch (vec) {
    case 1: return launch<float, 1, true>(GRAPHSAGE_MEAN_ARGS);
    case 2: return launch<float, 2, true>(GRAPHSAGE_MEAN_ARGS);
    case 4: return launch<float, 4, true>(GRAPHSAGE_MEAN_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int graphsage_gather_mean_dedup_bf16(GRAPHSAGE_MEAN_PARAMS) {
  switch (vec) {
    case 1: return launch<__nv_bfloat16, 1, true>(GRAPHSAGE_MEAN_ARGS);
    case 2: return launch<__nv_bfloat16, 2, true>(GRAPHSAGE_MEAN_ARGS);
    case 4: return launch<__nv_bfloat16, 4, true>(GRAPHSAGE_MEAN_ARGS);
    case 8: return launch<__nv_bfloat16, 8, true>(GRAPHSAGE_MEAN_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#undef GRAPHSAGE_MEAN_ARGS
#undef GRAPHSAGE_MEAN_PARAMS

// K2: feat, idx, out, n_rows, B, S, F and vec as above, plus the
// generator's seed, the (step, tag) counter words, the keep threshold
// and the 1/keep scale.
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

const char* graphsage_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
