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
// A table that is a column block (a rank's columns col_base .. of rows
// row_width wide, under tensor parallelism) takes its element (r, f) as
// (r, col_base + f) of the whole row: g = r*row_groups + (col_base+f)/4
// with row_groups = ceil(row_width/4) and col_base a multiple of 4, so
// the block's mask is the matching columns of the whole row's; a table
// that is the whole row passes col_base 0 and row_groups ceil(F/4).
// The two cases are two instances (kBlock): the whole row's computes its
// group count from F, the block's takes both values from the arguments.
//
// What bounds K2: operations, not bytes. Its bytes are K1's, but every
// element takes its own 32-bit word of a Philox call: per four elements
// 10 rounds of two 32x32->64 multiplies (one IMAD.WIDE.U32 each) and two
// three-input XORs (one LOP3 each: the round keys are the same for every
// thread), plus a compare an element, about 11 integer instructions an
// element: at the serving hop (77M elements) 0.05 ms at the H100's int32
// rate, above the ~0.013 ms bytes bound. The mask is kept bit for bit (no
// fewer rounds, no fewer bits, the same element-to-word map), so the
// design cuts everything around the generator instead:
//   * the B x ceil(F/W) items, an output row's chunk of W = max(4, VEC)
//     columns (whole Philox groups, so each call's four words serve four
//     elements), lie flat over blocks of 256 threads: every lane works
//     whatever F (one block per output row left 21% of the lanes idle on
//     the 298-column block of a tensor-parallel rank); the one or two
//     rows a warp spans make its id loads broadcasts;
//   * a thread walks its row's S samples U at a time: it loads the U ids
//     (an id outside [0, N) traps) and issues the U rows' loads (VEC
//     elements a load, the widest up to 16 bytes that divides F and the
//     table's alignment, so a vector is all in or all out of the row),
//     then runs the U samples' Philox calls, four independent chains
//     whatever W, round by round so that their multiplies interleave,
//     while the loads land (the multiplies set K2's pace: 20 a call, on
//     the SM's one multiply pipe);
//   * the 20 round keys are computed on the host and passed by value
//     (__grid_constant__): each XOR takes its key from the parameter
//     bank, with no register and no add for the key schedule;
//   * a kept element costs a compare and a predicated add: the sum is of
//     the raw values, and scale x 1/S multiplies it once at the end
//     (bit-equal to scaling each value where the scale is a power of 2,
//     as at rate 0.5);
//   * the counter steps by the row's group count from sample to sample;
//     where every counter of the launch fits 32 bits (B x S x row_groups
//     below 2^32, any realistic shape: 19.3M at the hop), the counters
//     are 32-bit and the high counter word the constant 0 (kWide false):
//     one multiply of each of the first two rounds then takes words that
//     are the same for every thread, which the compiler computes once,
//     outside the loop (18 multiplies a call; 5-7% faster than the
//     64-bit counters at the hop and on the tensor-parallel blocks, on
//     an H100 SXM: PERF.md §6);
//     otherwise the counters are 64-bit (kWide true);
//   * f32 accumulators in registers, the samples added in order: no
//     float atomics, two launches are bit-identical.
// chip_smoke.py counts the SASS instructions per element of K2's inner
// loop beside its bound.
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

using graphsage::philox4x32_10;
using graphsage::PhiloxKeys;
using graphsage::to_float;

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

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

int block_threads(int work_items) {
  int threads = (work_items + 31) / 32 * 32;
  return threads > 1024 ? 1024 : threads;
}

// ------------------------------------------------------------------ K2

constexpr int kDropThreads = 256;  // K2's threads a block, items laid flat

// K2's NS samples from ids on (their counters from g on, groups apart),
// added into acc where kept: the NS ids loaded and checked together,
// then the rows' loads issued, then the samples' Philox calls. Only the
// item's first n_cols columns lie in the row (fewer than W in a row's
// last chunk only: a predicate that the thread computes once).
template <typename T, int VEC, int NS, typename Ctr>
__device__ __forceinline__ void k2_samples(
    float* acc, const int32_t* ids, const char* base, uint32_t row_bytes,
    int n_cols, uint32_t n_ids, Ctr g, Ctr groups, uint32_t step,
    uint32_t tag, const PhiloxKeys& keys, uint32_t threshold) {
  constexpr int W = VEC > 4 ? VEC : 4;
  constexpr int Q = W / 4;
  constexpr int NV = W / VEC;
  uint32_t r[NS];
  bool bad = false;
#pragma unroll
  for (int u = 0; u < NS; ++u) {
    r[u] = static_cast<uint32_t>(__ldg(ids + u));
    bad |= r[u] >= n_ids;
  }
  if (bad) __trap();
  Vec<T, VEC> x[NS][NV];
#pragma unroll
  for (int u = 0; u < NS; ++u) {
    const T* p = reinterpret_cast<const T*>(
        base + static_cast<uint64_t>(r[u]) * row_bytes);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (j * VEC < n_cols) x[u][j] = ldg_vec<T, VEC>(p + j * VEC);
    }
  }
  uint4 c[NS * Q];   // the counters, then the words
#pragma unroll
  for (int u = 0; u < NS; ++u) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const Ctr gq = g + static_cast<Ctr>(u) * groups + static_cast<Ctr>(q);
      uint32_t hi = 0u;
      if constexpr (sizeof(Ctr) == 8) hi = static_cast<uint32_t>(gq >> 32);
      c[u * Q + q] = make_uint4(static_cast<uint32_t>(gq), hi, step, tag);
    }
  }
  philox4x32_10(c, keys);
#pragma unroll
  for (int u = 0; u < NS; ++u) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const uint32_t bits[4] = {c[u * Q + q].x, c[u * Q + q].y,
                                c[u * Q + q].z, c[u * Q + q].w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int e = 4 * q + k;
        if ((e / VEC) * VEC < n_cols && bits[k] < threshold) {
          acc[e] += to_float(x[u][e / VEC].v[e % VEC]);
        }
      }
    }
  }
}

// K2's item over the row's S samples: U at a time (four Philox chains),
// then the S % U left over at once.
template <typename T, int VEC, typename Ctr>
__device__ __forceinline__ void k2_row(
    float* acc, const int32_t* ids, const char* base, uint32_t row_bytes,
    int n_cols, uint32_t n_ids, int S, Ctr g, Ctr groups, uint32_t step,
    uint32_t tag, const PhiloxKeys& keys, uint32_t threshold) {
  constexpr int U = 4 / ((VEC > 4 ? VEC : 4) / 4);  // four chains
  int s = 0;
  for (; s + U <= S; s += U, g += U * groups) {
    k2_samples<T, VEC, U>(acc, ids + s, base, row_bytes, n_cols,
                                 n_ids, g, groups, step, tag, keys,
                                 threshold);
  }
#define K2_TAIL(NS)                                                         \
  k2_samples<T, VEC, NS>(acc, ids + s, base, row_bytes, n_cols,             \
                                n_ids, g, groups, step, tag, keys,          \
                                threshold)
  if constexpr (U == 4) {
    switch (S - s) {
      case 3: K2_TAIL(3); break;
      case 2: K2_TAIL(2); break;
      case 1: K2_TAIL(1); break;
      default: break;
    }
  } else {
    if (S - s == 1) K2_TAIL(1);
  }
#undef K2_TAIL
}

// K2: one thread per item (output row b, chunk of W columns at col0).
// n_ids: ids at or past it trap (min(N, 2^31)); out_scale: scale / S.
template <typename T, int VEC, bool kBlock, bool kWide>
__global__ void __launch_bounds__(kDropThreads)
    gather_mean_dropout_kernel(const T* __restrict__ feat,
                               const int32_t* __restrict__ idx,
                               float* __restrict__ out, uint32_t n_ids,
                               int B, int S, int F, int n_chunks,
                               float out_scale,
                               const __grid_constant__ PhiloxKeys keys,
                               uint32_t step, uint32_t tag,
                               uint32_t threshold, int col_base,
                               int64_t row_groups) {
  constexpr int W = VEC > 4 ? VEC : 4;  // columns an item: whole groups
  constexpr int NV = W / VEC;           // loads a sample
  using Ctr = std::conditional_t<kWide, uint64_t, uint32_t>;
  const Ctr n_chunk = static_cast<Ctr>(n_chunks);
  const Ctr item = static_cast<Ctr>(blockIdx.x) * kDropThreads + threadIdx.x;
  if (item >= static_cast<Ctr>(B) * n_chunk) return;
  const Ctr b = item / n_chunk;
  const int col0 = static_cast<int>(item - b * n_chunk) * W;
  const int n_cols = F - col0;
  const Ctr groups = kBlock ? static_cast<Ctr>(row_groups)
                            : static_cast<Ctr>((F + 3) / 4);
  // the group of the item's first column in the row's first sample
  Ctr g = b * static_cast<Ctr>(S) * groups
          + static_cast<Ctr>(((kBlock ? col_base : 0) + col0) / 4);
  const int32_t* ids = idx + static_cast<int64_t>(b) * S;
  const char* base = reinterpret_cast<const char*>(feat + col0);
  const uint32_t row_bytes = static_cast<uint32_t>(F * sizeof(T));

  float acc[W];
#pragma unroll
  for (int e = 0; e < W; ++e) acc[e] = 0.f;
  k2_row<T, VEC>(acc, ids, base, row_bytes, n_cols, n_ids, S, g, groups,
                 step, tag, keys, threshold);
  float* o = out + static_cast<int64_t>(b) * F + col0;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (j * VEC < n_cols) {
      Vec<float, VEC> y;
#pragma unroll
      for (int k = 0; k < VEC; ++k) y.v[k] = acc[j * VEC + k] * out_scale;
      *reinterpret_cast<Vec<float, VEC>*>(o + j * VEC) = y;
    }
  }
}

template <typename T, int VEC>
int launch_dropout(const void* feat, const void* idx, void* out,
                   long long n_rows, int B, int S, int F,
                   unsigned long long seed, unsigned int step,
                   unsigned int tag, unsigned int threshold, float scale,
                   int col_base, long long row_groups, void* stream) {
  constexpr int W = VEC > 4 ? VEC : 4;
  const int n_chunks = (F + W - 1) / W;
  const long long blocks =
      (static_cast<long long>(B) * n_chunks + kDropThreads - 1)
      / kDropThreads;
  if (B <= 0 || S <= 0 || F <= 0 || row_groups < (F + 3) / 4
      || blocks > 0x7fffffffLL
      || static_cast<unsigned long long>(F) * sizeof(T) > 0xffffffffULL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool block = col_base != 0 || row_groups != (F + 3) / 4;
  // every counter below B*S*row_groups, every item below blocks*256
  const unsigned long long top =
      static_cast<unsigned long long>(B) * S * row_groups + kDropThreads;
  const bool wide = top > 0xffffffffULL;
  auto kernel =
      block ? (wide ? gather_mean_dropout_kernel<T, VEC, true, true>
                    : gather_mean_dropout_kernel<T, VEC, true, false>)
            : (wide ? gather_mean_dropout_kernel<T, VEC, false, true>
                    : gather_mean_dropout_kernel<T, VEC, false, false>);
  const uint32_t n_ids = static_cast<uint32_t>(
      n_rows < (1LL << 31) ? n_rows : (1LL << 31));
  const float out_scale = scale * (1.0f / static_cast<float>(S));
  kernel<<<static_cast<unsigned int>(blocks), kDropThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(feat), static_cast<const int32_t*>(idx),
      static_cast<float*>(out), n_ids, B, S, F, n_chunks, out_scale,
      graphsage::philox_keys(static_cast<uint32_t>(seed),
                             static_cast<uint32_t>(seed >> 32)),
      step, tag, threshold, col_base, row_groups);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------- K1 and K3

constexpr int kMaxThreads = 512;  // at most 128 registers a thread

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
// generator's seed, the (step, tag) counter words, the keep threshold,
// the 1/keep scale, and the block's first column and its whole row's
// Philox groups (0 and ceil(F/4) for a whole table).
#define GRAPHSAGE_DROPOUT_ARGS                                              \
  feat, idx, out, n_rows, B, S, F, seed, step, tag, threshold, scale,       \
      col_base, row_groups, stream

int graphsage_gather_mean_dropout_f32(
    const void* feat, const void* idx, void* out, long long n_rows, int B,
    int S, int F, int vec, unsigned long long seed, unsigned int step,
    unsigned int tag, unsigned int threshold, float scale, int col_base,
    long long row_groups, void* stream) {
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
    unsigned int tag, unsigned int threshold, float scale, int col_base,
    long long row_groups, void* stream) {
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
