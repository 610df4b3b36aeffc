// Fused gather -> per-neighbour MLP -> pool for Hopper (sm_90a).
//
//   X[r, :]   = feat[idx[r], :] in f32, r = b*S + s, dropped per element
//               by the Philox mask of graphsage_tpu_torch/ops/philox.py
//               when dropping (kept values scaled by 1/keep)
//   out[b, h] = reduce_s relu(sum_f X[b*S + s, f] * w[f, h] + bias[h])
//   reduce    = mean (the sum times 1/S) or max over the S rows of b
//
// K5 replaces graphsage_tpu/ops/pool.py::_kernel with want_x=False, as
// fused_gather_mlp_pool calls it (pool.py:79-113, call :187). K6
// replaces the same kernel with want_x=True, the forward of
// gather_mlp_pool_train's custom VJP (pool.py:308-389): it also writes
// the dropped rows X [B*S, F] f32, once, as the backward's residual.
// Beyond that residual, neither the gathered rows nor the [B*S, H]
// activations reach device memory: only the [B, H] f32 result.
//
// What bounds it on the H100: operations. At the serving hop (idx
// [5120, 25] into a [100001, 602] f32 table, w [602, 512]) the product
// is 2 x 128000 x 602 x 512 = 78.9 GFLOP, 1.178 ms at 67 TFLOP/s in f32
// outside the tensor cores (TF32 would break parity with the reference's
// "highest" precision), against ~71 MB of bytes (the distinct gathered
// rows, w, the output), 0.021 ms at 3.35 TB/s. K6 adds the 308 MB
// residual (0.092 ms) and the Philox draws (~0.05 ms of int32 work), and
// stays bound by operations.
//
// Design (a simple, correct first version, on the CUDA cores in f32):
//   * a block owns BR = max(1, 128 / S) whole output rows (all S of their
//     gathered rows, at most 128 rows of the product) and a tile of 128 of
//     the H columns. The H tiles of one row group are neighbours in the
//     launch order, so the group's rows come from HBM once and from L2
//     for the other tiles;
//   * it loops over F in tiles of 16: the tile of gathered (and dropped)
//     rows and the matching 16 rows of w go to shared memory, the next
//     tile's loads are issued before the current one is used, and each of
//     256 threads accumulates an 8 x 8 block of z in registers;
//   * the epilogue adds the bias, applies relu, writes the 128 x 128 tile
//     of activations to shared memory and reduces each output row's S
//     rows there in a fixed order: no float atomics, so results repeat
//     bit for bit. For S > 128 a block owns one output row and carries
//     its reduce over chunks of 128 rows;
//   * an element's Philox bits depend on its position only, so the
//     blocks of every H tile draw the same mask; only the blocks of the
//     first H tile write the residual, exactly once per element;
//   * row offsets are 64-bit (idx * F overflows int32 beyond ~3.5M rows
//     at F = 602); an out-of-range index traps, as in K1;
//   * any F and H: the last F tile and the last H tile are masked. The
//     table is f32 or bf16 (upcast on load); w, bias and out are f32.
// Left for later work: wgmma on the tensor cores (3xTF32 for f32-accurate
// products, or bf16 with f32 accumulation where parity allows), TMA or
// cp.async multi-stage buffering, and a persistent schedule.
//
// Plain C interface for ctypes; each entry point returns
// cudaGetLastError() after its launch (or the error of the launch's
// shared-memory setting).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace {

using graphsage::philox_group;
using graphsage::to_float;

constexpr int kMT = 128;        // rows of the product per block and chunk
constexpr int kNT = 128;        // H columns per block
constexpr int kKT = 16;         // F columns per shared-memory tile
constexpr int kThreads = 256;   // 16 x 16 threads, 8 x 8 outputs each
constexpr int kLdA = kMT + 4;   // As[k][m]: the pad keeps float4 alignment
constexpr int kLdH = kNT + 4;   // Hs[m][n]
constexpr int kTileFloats = kKT * kLdA + kKT * kNT;
constexpr int kHFloats = kMT * kLdH;
constexpr int kSmemFloats = kTileFloats > kHFloats ? kTileFloats : kHFloats;
constexpr size_t kSmemBytes =
    kMT * sizeof(int64_t) + kSmemFloats * sizeof(float);

struct Args {
  const void* feat;
  const int32_t* idx;
  const float* w;
  const float* bias;
  float* out;
  float* x;            // the residual [B*S, F], written by K6 only
  int64_t n_rows;      // rows of the table
  int B, S, F, H;
  int rows_per_block;  // BR
  int n_htiles;
  uint32_t seed_lo, seed_hi, step, tag, threshold;
  float scale, inv_s;
};

template <typename T, bool MAX, bool DROP, bool WANT_X>
__global__ void __launch_bounds__(kThreads, 2)
gather_mlp_pool_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int64_t* row_off = reinterpret_cast<int64_t*>(smem_raw);
  float* smem = reinterpret_cast<float*>(smem_raw + kMT * sizeof(int64_t));
  float* As = smem;                 // [kKT][kLdA]
  float* Bs = smem + kKT * kLdA;    // [kKT][kNT]
  float* Hs = smem;                 // [kMT][kLdH], after the main loop

  const T* __restrict__ feat = static_cast<const T*>(a.feat);
  const int t = threadIdx.x;
  const int tx = t & 15, ty = t >> 4;
  const int group = blockIdx.x / a.n_htiles;
  const int htile = blockIdx.x - group * a.n_htiles;
  const int h0 = htile * kNT;
  const int64_t b0 = static_cast<int64_t>(group) * a.rows_per_block;
  const int nb = static_cast<int>(
      min(static_cast<int64_t>(a.rows_per_block), a.B - b0));
  const int S = a.S, F = a.F, H = a.H;
  const int block_rows = nb * S;
  const int64_t g0 = b0 * S;        // first gathered row of the block
  const int64_t groups_per_row = (F + 3) / 4;
  const bool write_x = WANT_X && htile == 0;
  const int n_ktiles = (F + kKT - 1) / kKT;

  // the A loader: 4 columns (one Philox group) of rows m0 and m0 + 64
  const int aq = t & 3, am0 = t >> 2;
  // the B loader: row k of the w tile, 8 columns from n0
  const int bk = t >> 4, bn0 = (t & 15) * 8;

  float run = 0.f;  // the reduce carried over chunks when S > kMT
  for (int c0 = 0; c0 < block_rows; c0 += kMT) {
    const int rows_c = min(kMT, block_rows - c0);
    for (int m = t; m < kMT; m += kThreads) {
      int64_t off = -1;
      if (m < rows_c) {
        const int64_t r = a.idx[g0 + c0 + m];
        if (r < 0 || r >= a.n_rows) __trap();
        off = r * F;
      }
      row_off[m] = off;
    }
    __syncthreads();

    float areg[2][4], breg[8];
    auto load_tile = [&](int kt) {
      const int f0 = kt * kKT;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int m = am0 + 64 * p;
        const int64_t off = row_off[m];
        const int f = f0 + 4 * aq;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          areg[p][e] = (off >= 0 && f + e < F)
                           ? to_float(feat[off + f + e]) : 0.f;
        }
        if (off >= 0 && f < F) {
          const int64_t grow = g0 + c0 + m;
          if (DROP) {
            const uint4 r = philox_group(
                static_cast<uint64_t>(grow * groups_per_row + (f >> 2)),
                a.step, a.tag, a.seed_lo, a.seed_hi);
            const uint32_t bits[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              areg[p][e] = bits[e] < a.threshold ? areg[p][e] * a.scale : 0.f;
            }
          }
          if (write_x) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (f + e < F) a.x[grow * F + f + e] = areg[p][e];
            }
          }
        }
      }
      const int fk = f0 + bk;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int h = h0 + bn0 + j;
        breg[j] = (fk < F && h < H)
                      ? a.w[static_cast<int64_t>(fk) * H + h] : 0.f;
      }
    };

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }

    load_tile(0);
    for (int kt = 0; kt < n_ktiles; ++kt) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          As[(4 * aq + e) * kLdA + am0 + 64 * p] = areg[p][e];
        }
      }
      *reinterpret_cast<float4*>(&Bs[bk * kNT + bn0]) =
          make_float4(breg[0], breg[1], breg[2], breg[3]);
      *reinterpret_cast<float4*>(&Bs[bk * kNT + bn0 + 4]) =
          make_float4(breg[4], breg[5], breg[6], breg[7]);
      __syncthreads();
      if (kt + 1 < n_ktiles) load_tile(kt + 1);
#pragma unroll
      for (int k = 0; k < kKT; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(
            &As[k * kLdA + ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(
            &As[k * kLdA + 64 + ty * 4]);
        const float4 v0 = *reinterpret_cast<const float4*>(
            &Bs[k * kNT + tx * 4]);
        const float4 v1 = *reinterpret_cast<const float4*>(
            &Bs[k * kNT + 64 + tx * 4]);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
          }
        }
      }
      __syncthreads();
    }

    // bias and relu into Hs; rows ty*4+i and 64+ty*4+i, columns likewise
    float bias[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int h = h0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      bias[j] = h < H ? a.bias[h] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float4 v;
        v.x = fmaxf(acc[i][4 * half + 0] + bias[4 * half + 0], 0.f);
        v.y = fmaxf(acc[i][4 * half + 1] + bias[4 * half + 1], 0.f);
        v.z = fmaxf(acc[i][4 * half + 2] + bias[4 * half + 2], 0.f);
        v.w = fmaxf(acc[i][4 * half + 3] + bias[4 * half + 3], 0.f);
        *reinterpret_cast<float4*>(&Hs[m * kLdH + 64 * half + tx * 4]) = v;
      }
    }
    __syncthreads();

    // the reduce over each output row's rows in this chunk, in row order
    for (int p = t; p < nb * kNT; p += kThreads) {
      const int lb = p / kNT, col = p - lb * kNT;
      const int lo = max(lb * S, c0), hi = min(lb * S + S, c0 + rows_c);
      if (lo >= hi) continue;
      float v = Hs[(lo - c0) * kLdH + col];
      for (int r = lo + 1; r < hi; ++r) {
        const float hv = Hs[(r - c0) * kLdH + col];
        v = MAX ? fmaxf(v, hv) : v + hv;
      }
      if (lo != lb * S) v = MAX ? fmaxf(run, v) : run + v;
      if (hi == lb * S + S) {
        const int h = h0 + col;
        if (h < H) a.out[(b0 + lb) * H + h] = MAX ? v : v * a.inv_s;
      } else {
        run = v;  // S > kMT: one output row, p == t < kNT
      }
    }
    __syncthreads();
  }
}

template <typename T, bool MAX, bool DROP, bool WANT_X>
int launch(const Args& a, cudaStream_t stream) {
  auto kernel = gather_mlp_pool_kernel<T, MAX, DROP, WANT_X>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_groups =
      (a.B + a.rows_per_block - 1) / a.rows_per_block;
  const long long n_blocks = n_groups * a.n_htiles;
  if (n_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(n_blocks), kThreads, kSmemBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Args& a, int reduce_max, int dropout, int want_x,
             cudaStream_t stream) {
  const int key = (reduce_max ? 4 : 0) | (dropout ? 2 : 0) | (want_x ? 1 : 0);
  switch (key) {
    case 0: return launch<T, false, false, false>(a, stream);
    case 1: return launch<T, false, false, true>(a, stream);
    case 2: return launch<T, false, true, false>(a, stream);
    case 3: return launch<T, false, true, true>(a, stream);
    case 4: return launch<T, true, false, false>(a, stream);
    case 5: return launch<T, true, false, true>(a, stream);
    case 6: return launch<T, true, true, false>(a, stream);
    default: return launch<T, true, true, true>(a, stream);
  }
}

Args make_args(const void* feat, const void* idx, const void* w,
               const void* bias, void* out, void* x, long long n_rows, int B,
               int S, int F, int H, unsigned long long seed,
               unsigned int step, unsigned int tag, unsigned int threshold,
               float scale) {
  Args a;
  a.feat = feat;
  a.idx = static_cast<const int32_t*>(idx);
  a.w = static_cast<const float*>(w);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<float*>(out);
  a.x = static_cast<float*>(x);
  a.n_rows = n_rows;
  a.B = B;
  a.S = S;
  a.F = F;
  a.H = H;
  a.rows_per_block = S <= kMT ? kMT / S : 1;
  a.n_htiles = (H + kNT - 1) / kNT;
  a.seed_lo = static_cast<uint32_t>(seed);
  a.seed_hi = static_cast<uint32_t>(seed >> 32);
  a.step = step;
  a.tag = tag;
  a.threshold = threshold;
  a.scale = scale;
  a.inv_s = 1.0f / S;
  return a;
}

}  // namespace

extern "C" {

// K5 (want_x = 0) and K6 (want_x = 1, x = the [B*S, F] f32 residual).
// reduce_max: 1 for max, 0 for mean. With dropout = 0 the seed, step,
// tag, threshold and scale are not read.
#define GRAPHSAGE_POOL_PARAMS                                               \
  const void *feat, const void *idx, const void *w, const void *bias,       \
      void *out, void *x, long long n_rows, int B, int S, int F, int H,     \
      int reduce_max, int dropout, int want_x, unsigned long long seed,     \
      unsigned int step, unsigned int tag, unsigned int threshold,          \
      float scale, void *stream
#define GRAPHSAGE_POOL_ARGS                                                 \
  make_args(feat, idx, w, bias, out, x, n_rows, B, S, F, H, seed, step,     \
            tag, threshold, scale),                                         \
      reduce_max, dropout, want_x, static_cast<cudaStream_t>(stream)

int graphsage_gather_mlp_pool_f32(GRAPHSAGE_POOL_PARAMS) {
  return dispatch<float>(GRAPHSAGE_POOL_ARGS);
}

int graphsage_gather_mlp_pool_bf16(GRAPHSAGE_POOL_PARAMS) {
  return dispatch<__nv_bfloat16>(GRAPHSAGE_POOL_ARGS);
}

#undef GRAPHSAGE_POOL_ARGS
#undef GRAPHSAGE_POOL_PARAMS

const char* graphsage_pool_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
