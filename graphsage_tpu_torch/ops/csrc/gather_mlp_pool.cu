// Fused gather -> per-neighbour MLP -> pool for Hopper (sm_90a), on the
// tensor cores in 3xTF32.
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
// is 2 x 128000 x 602 x 512 = 78.9 GFLOP against ~71 MB of bytes (the
// distinct gathered rows, w, the output: 0.021 ms at 3.35 TB/s). The
// product has to be f32-accurate: the reference runs it at "highest"
// precision and the port holds the kernel to 5e-5 of an f32 product.
// A single TF32 pass keeps 10 mantissa bits of each operand and misses
// that by ~4x (2.0e-4 on the pooled mean at the hop's widths,
// tests/test_torch_pool_tf32.py). 3xTF32 does not: each operand x is
// split into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna), and
// hi*lo + lo*hi + hi*hi (lo*lo dropped) is summed in f32 by the tensor
// cores. That is three products at 495 TFLOP/s: 0.478 ms, against 1.18
// ms for one f32 product on the CUDA cores. A bf16 row is exact in TF32
// (lo = 0), so a bf16 table without dropout needs two products: 0.319
// ms. With dropout the scaled row is no longer exact and takes three.
// K6 adds the 308 MB residual (0.092 ms) and the Philox draws.
//
// Design:
//   * a block owns BR = max(1, 256 / S) whole output rows (all S of
//     their gathered rows, at most 256 rows of the product) and a tile
//     of 128 of the H columns. Two warpgroups each own 128 of the rows
//     and keep 2 x (64 x 128) f32 accumulators in registers (wgmma
//     m64n128k8). The H tiles of one row group are neighbours in the
//     launch order, so the group's rows come from HBM once and from L2
//     for the other tiles. 256 rows a block halve the L2 traffic of w
//     against 128 rows: every block streams all of w's tile;
//   * w is prepared per launch by split_w_kernel: its hi and lo TF32
//     parts, transposed to [2, H_pad, F_pad] (K-major, as wgmma wants
//     .tf32 operands), zero-padded to F_pad = 8k and H_pad = 128k;
//   * the gathered rows cannot come through TMA (it does not gather by
//     index, and an f32 row of 602 is only 8-byte aligned), so every
//     thread issues cp.async copies in the widest unit that divides the
//     row and the table's alignment (16, 8 or 4 bytes; 2-byte bf16 rows
//     are copied by plain loads), four threads to a row at F = 602. A
//     ring of 6 stages of 8 F columns keeps 3-4 in flight; a stage holds
//     w^T's hi and lo [128, 8] tiles in wgmma's canonical no-swizzle
//     layout (8-row x 16-byte core matrices, copied 16 bytes at a time)
//     and the raw rows, 32 bytes each with their 16-byte halves swapped
//     in rows 4-7 of every 8 (raw_byte), so that fragment loads do not
//     collide in banks. Columns past F are zero-filled there;
//   * A is split in registers and fed to wgmma from registers: each
//     thread loads its fragment (4 rows x 2 columns a 64-row half) from
//     the stage and splits it with cvt.rna. With A in shared memory as
//     well, wgmma alone would read 96 bytes a clock from it at the TF32
//     peak, beside the ring's writes and a split pass's traffic: a first
//     version built so was slower;
//   * dropout and K6's residual take a row pass before the fragment
//     loads: each thread upcasts one row of the stage, applies the
//     Philox mask and 1/keep with K2's counters, stores the residual
//     (blocks of the first H tile only, exactly once per element,
//     streaming stores that do not evict the table from L2) and writes
//     the dropped f32 row back in place; a warpgroup's fragments are its
//     own rows, so a warpgroup barrier orders the two;
//   * per stage a warpgroup issues, per 64-row half, hi*w_lo, lo*w_hi
//     (not for a bf16 table outside K6 and dropout) and hi*w_hi into one f32
//     accumulator, and waits only for the stage before, so the products
//     of stage k overlap the copies and fragment loads of stage k+1; the
//     fragments are double-buffered in registers for that;
//   * the tensor cores truncate the f32 accumulator at every wgmma. Over
//     F = 602 that is 228 truncations into one sum: chip_smoke.py saw
//     K6 (scaled rows, max reduce) drift 6.4e-5 from the plain version,
//     beyond the 5e-5 the kernel is held to. So every 16 stages each
//     thread adds its accumulators into f32 sums in shared memory (one
//     128 KB tile in the accumulators' order, no bank conflicts) and the
//     next wgmma restarts them (scale-d 0, so no other instruction
//     writes them while a wgmma is in flight): 1.6e-5;
//   * the epilogue adds the bias and applies relu to the sums in place
//     and reduces each output row's S rows in a fixed order: no float
//     atomics, so results repeat bit for bit. For S > 256 a block owns
//     one output row and carries its reduce over chunks of 256 rows;
//   * row offsets are 64-bit (idx * F overflows int32 beyond ~3.5M rows
//     at F = 602); an out-of-range index traps, as in K1;
//   * any F, H, S >= 1: the columns past F are zeros in the ring, w's
//     pads are zeros, rows past the block's only feed accumulator rows
//     the reduce never reads. The table is f32 or bf16; w, bias and out
//     are f32.
// What holds it back: not the products (with the copies switched off
// the kernel ran about twice as fast) but the copies of w's tiles and
// of the gathered rows from L2, 2.5 GB a launch (each block streams w's
// tile, each of the 4 H tiles re-reads its rows), and the promotions.
// Left for later work: TMA multicast of w's tiles across a cluster of
// row groups, which halves that traffic, and a persistent schedule that
// overlaps one tile's epilogue with the next one's loads.
//
// Plain C interface for ctypes; each entry point returns
// cudaGetLastError() after its launches (or the error of the launch's
// shared-memory setting).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "philox.cuh"

namespace {

using graphsage::philox_group;
using graphsage::to_float;

constexpr int kMT = 256;          // rows of the product per block and chunk
constexpr int kNT = 128;          // H columns per block: wgmma's N
constexpr int kKT = 8;            // F columns per ring stage: wgmma's K
constexpr int kStages = 6;        // ring depth
constexpr int kThreads = 256;     // two warpgroups of 128
// stages a wgmma accumulation runs before it is added into the f32 sums
constexpr int kPromote = 16;
// a raw row of a stage: 8 f32 (or 8 bf16, or the dropped f32 written in
// place) in 32 bytes; raw_byte swaps its two 16-byte halves in rows 4-7
// of every 8, so that the fragment loads of a warp (8 rows x 4 columns)
// fall in distinct banks
constexpr int kRawPitch = 32;
constexpr int kRawBytes = kMT * kRawPitch;
constexpr int kWPartBytes = kNT * kKT * 4;            // one part of w^T
constexpr int kBBytes = 2 * kWPartBytes;              // hi + lo of w^T
constexpr int kStageBytes = kBBytes + kRawBytes;
constexpr int kPipeBytes = kStages * kStageBytes;
// the f32 sums of the 256 x 128 tile, in the accumulators' order: the
// thread's value i at [i][thread]
constexpr int kSumBytes = kMT * kNT * 4;
constexpr size_t kSmemBytes = kPipeBytes + kSumBytes + kMT * sizeof(int64_t);
// wgmma's canonical K-major no-swizzle layout of a [rows, 8] tf32 tile:
// core matrices of 8 rows x 16 bytes, the two along K kLBO apart, the
// 8-row groups kSBO apart
constexpr uint32_t kLBO = 128;
constexpr uint32_t kSBO = 256;

struct Args {
  const void* feat;
  const int32_t* idx;
  const float* wt;     // [2, h_pad, f_pad]: w^T's hi and lo TF32 parts
  const float* bias;
  float* out;
  float* x;            // the residual [B*S, F], written by K6 only
  int64_t n_rows;      // rows of the table
  int B, S, F, H;
  int f_pad, h_pad;
  int rows_per_block;  // BR
  int n_htiles;
  int unit;            // bytes per row copy: 16, 8, 4 or 2
  uint32_t seed_lo, seed_hi, step, tag, threshold;
  float scale, inv_s;
};

__device__ __forceinline__ float tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t core_offset(int row, int k) {
  return (row >> 3) * kSBO + (k >> 2) * kLBO + (row & 7) * 16 + (k & 3) * 4;
}

__device__ __forceinline__ int raw_byte(int row, int byte) {
  return row * kRawPitch + (byte ^ (((row >> 2) & 1) << 4));
}

__device__ __forceinline__ uint64_t descriptor(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(kLBO >> 4) << 16)
         | (static_cast<uint64_t>(kSBO >> 4) << 32);
}

// a U-byte copy into shared memory (dst its address, dst_generic the
// same place as a pointer): cp.async, or a plain load and store for the
// 2-byte rows of an odd-width bf16 table (cp.async has no 2-byte copy)
template <int U>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         void* dst_generic) {
  if constexpr (U == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(dst), "l"(src) : "memory");
  } else if constexpr (U == 8 || U == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(dst), "l"(src), "n"(U) : "memory");
  } else {
    *static_cast<uint16_t*>(dst_generic) =
        *static_cast<const uint16_t*>(src);
  }
}

// U zero bytes into shared memory
template <int U>
__device__ __forceinline__ void zero_fill(void* dst) {
  if constexpr (U == 16) {
    *static_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  } else if constexpr (U == 8) {
    *static_cast<uint2*>(dst) = make_uint2(0, 0);
  } else if constexpr (U == 4) {
    *static_cast<uint32_t*>(dst) = 0;
  } else {
    *static_cast<uint16_t*>(dst) = 0;
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// shared memory written in the generic proxy (cp.async) made visible to
// wgmma's reads in the async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(wg + 1) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// d[64 x 128] = A[64 x 8] * B[8 x 128] + (accumulate ? d : 0) in tf32:
// A from registers (the
// thread's a[2c + j] is row 16*warp + lane/4 + 8j, column lane%4 + 4c),
// B K-major in shared memory; the thread's d[4i + 2j + e] is row
// 16*warp + lane/4 + 8j, column 8i + 2*(lane%4) + e
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// keeps the compiler from moving reads of d across a wgmma wait
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// wt[p, n, k] = part p (0 hi, 1 lo) of tf32(w[k, n]), zero in the pads;
// a 32 x 32 tile through shared memory per block of 32 x 8 threads
__global__ void split_w_kernel(const float* __restrict__ w, float* wt,
                               int F, int H, int f_pad, int h_pad) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32, n0 = blockIdx.y * 32;
  for (int dk = threadIdx.y; dk < 32; dk += 8) {
    const int k = k0 + dk, n = n0 + threadIdx.x;
    tile[dk][threadIdx.x] =
        (k < F && n < H) ? w[static_cast<int64_t>(k) * H + n] : 0.f;
  }
  __syncthreads();
  for (int dn = threadIdx.y; dn < 32; dn += 8) {
    const int n = n0 + dn, k = k0 + threadIdx.x;
    if (n < h_pad && k < f_pad) {
      const float v = tile[threadIdx.x][dn];
      const float hi = tf32_rna(v);
      wt[static_cast<int64_t>(n) * f_pad + k] = hi;
      wt[(static_cast<int64_t>(h_pad) + n) * f_pad + k] = tf32_rna(v - hi);
    }
  }
}

template <typename T, bool MAX, bool DROP, bool WANT_X>
__global__ void __launch_bounds__(kThreads, 1)
gather_mlp_pool_kernel(const Args a) {
  // a row pass (the mask, the residual) rewrites a stage's rows in place
  // as f32; otherwise the fragments read the table's type. A bf16 row is
  // exact in TF32 (lo = 0, one product fewer) unless the pass scaled it
  constexpr bool kPass = DROP || WANT_X;
  constexpr bool kF32Rows = kPass || sizeof(T) == 4;
  constexpr int kRowBytes = kKT * static_cast<int>(sizeof(T));
  extern __shared__ __align__(128) unsigned char smem[];
  float* sums = reinterpret_cast<float*>(smem + kPipeBytes);
  int64_t* row_off = reinterpret_cast<int64_t*>(smem + kPipeBytes
                                                + kSumBytes);

  const T* __restrict__ feat = static_cast<const T*>(a.feat);
  const int t = threadIdx.x;
  const int wg = t >> 7, warp = (t >> 5) & 3;
  const int g = (t & 31) >> 2, q = t & 3;
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
  const int n_ktiles = a.f_pad / kKT;
  const uint32_t smem0 = smem_addr(smem);

  // this thread's copies of w^T in every stage: row n, 16 bytes kc of
  // both parts
  const int n_w = t >> 1, kc = t & 1;
  const float* w_src = a.wt + static_cast<int64_t>(h0 + n_w) * a.f_pad
                       + 4 * kc;
  const int64_t w_part = static_cast<int64_t>(a.h_pad) * a.f_pad;
  const uint32_t w_dst = core_offset(n_w, 4 * kc);
  // the thread's fragment rows 16*warp + g (+8, +64, +72) of its
  // warpgroup, columns q and q + 4: byte offsets in a stage's raw rows
  const int frag_row = (wg * 128 + warp * 16 + g) * kRawPitch + 4 * q;
  // (raw_byte's swap of 16-byte halves: rows g and 8j + g share it)
  const int frag_c0 = ((g >> 2) & 1) << 4, frag_c1 = frag_c0 ^ 16;

  // the accumulators: the first product after each promotion overwrites
  // them, so that no instruction but wgmma writes them in the loop
  float acc[2][64];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
  }
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

    // the chunk's raw rows at columns f0.. of a stage, in U-byte copies:
    // thread t copies unit t % (units a row) of every (256 / units)-th
    // row; the columns past F are zero-filled
    auto copy_rows = [&](auto unit_bytes, int stage, int f0) {
      constexpr int U = decltype(unit_bytes)::value;
      constexpr int kUnits = kRowBytes / U;
      constexpr int kUnitElems = U / static_cast<int>(sizeof(T));
      const int j = t % kUnits;
      const int f = f0 + j * kUnitElems;
      const int stage_byte = stage * kStageBytes + kBBytes;
#pragma unroll
      for (int i = 0; i < kUnits; ++i) {
        const int m = t / kUnits + i * (kThreads / kUnits);
        const int64_t off = row_off[m];
        const int byte = stage_byte + raw_byte(m, j * U);
        if (off >= 0) {
          if (f < F) {
            cp_async<U>(smem0 + byte, feat + off + f, smem + byte);
          } else {
            zero_fill<U>(smem + byte);
          }
        }
      }
    };

    auto load_stage = [&](int kt) {
      if (kt < n_ktiles) {
        const int stage = kt % kStages;
        const uint32_t base = smem0 + stage * kStageBytes;
        const int f0 = kt * kKT;
        cp_async<16>(base + w_dst, w_src + f0, nullptr);
        cp_async<16>(base + kWPartBytes + w_dst, w_src + w_part + f0,
                     nullptr);
        switch (a.unit) {
          case 16:
            copy_rows(std::integral_constant<int, 16>(), stage, f0);
            break;
          case 8:
            copy_rows(std::integral_constant<int, 8>(), stage, f0);
            break;
          case 4:
            copy_rows(std::integral_constant<int, 4>(), stage, f0);
            break;
          default:
            copy_rows(std::integral_constant<int, 2>(), stage, f0);
        }
      }
      cp_async_commit();
    };

    // one stage: wait for it, refill the ring, (row pass), load the A
    // fragments and split them, issue the products; fr holds the
    // fragments until the wgmma that reads them is done
    auto step = [&](int kt, uint32_t (&fr)[2][2][4]) {
      const int stage = kt % kStages;
      // stage kt has landed (3 later stages may be in flight); every
      // warpgroup is done with the wgmma of stage kt - 2, whose slot the
      // next copies take
      cp_async_wait<kStages - 3>();
      fence_proxy_async();
      __syncthreads();
      load_stage(kt + kStages - 2);
      unsigned char* raw = smem + stage * kStageBytes + kBBytes;
      const int f0 = kt * kKT;

      if (kPass) {
        // thread t's row: upcast, mask and 1/keep, the residual, and the
        // dropped f32 row written back in place
        float v[kKT];
        if (t < rows_c) {
          T in[kKT];
#pragma unroll
          for (int e = 0; e < kKT; e += 16 / sizeof(T)) {
            *reinterpret_cast<uint4*>(in + e) =
                *reinterpret_cast<const uint4*>(
                    raw + raw_byte(t, e * sizeof(T)));
          }
#pragma unroll
          for (int e = 0; e < kKT; ++e) {
            v[e] = f0 + e < F ? to_float(in[e]) : 0.f;
          }
          const int64_t grow = g0 + c0 + t;
          if (DROP) {
#pragma unroll
            for (int p = 0; p < 2; ++p) {
              if (f0 + 4 * p < F) {
                const uint4 w4 = philox_group(
                    static_cast<uint64_t>(grow * groups_per_row
                                          + (f0 >> 2) + p),
                    a.step, a.tag, a.seed_lo, a.seed_hi);
                const uint32_t bits[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  v[4 * p + e] = bits[e] < a.threshold
                                     ? v[4 * p + e] * a.scale : 0.f;
                }
              }
            }
          }
          if (write_x) {
            float* xr = a.x + grow * F + f0;
            if ((F & 1) == 0 && f0 + kKT <= F) {
#pragma unroll
              for (int e = 0; e < kKT; e += 2) {
                __stcs(reinterpret_cast<float2*>(xr + e),
                       make_float2(v[e], v[e + 1]));
              }
            } else {
#pragma unroll
              for (int e = 0; e < kKT; ++e) {
                if (f0 + e < F) __stcs(xr + e, v[e]);
              }
            }
          }
        } else {
#pragma unroll
          for (int e = 0; e < kKT; ++e) v[e] = 0.f;
        }
        *reinterpret_cast<float4*>(raw + raw_byte(t, 0)) =
            make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(raw + raw_byte(t, 16)) =
            make_float4(v[4], v[5], v[6], v[7]);
        warpgroup_sync(wg);   // a warpgroup's fragments are its own rows
      }

      // A fragments, split into hi and lo in registers (the columns past
      // F are zeros in the stage)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const unsigned char* rc = raw + frag_row
                                      + (h * 64 + 8 * j) * kRawPitch;
            float v;
            if (kF32Rows) {
              v = *reinterpret_cast<const float*>(
                  rc + (c ? frag_c1 : frag_c0));
            } else {
              // a bf16 row fills the first 16 bytes: column q + 4c sits
              // at byte 2(q + 4c) of them, 4q bytes from frag_row
              v = to_float(*reinterpret_cast<const T*>(
                  rc - 2 * q + frag_c0 + 8 * c));
            }
            const float hi = tf32_rna(v);
            fr[h][0][2 * c + j] = __float_as_uint(hi);
            if (kF32Rows) {
              fr[h][1][2 * c + j] = __float_as_uint(tf32_rna(v - hi));
            }
          }
        }
      }

      wgmma_fence();
      const uint32_t w_hi = smem0 + stage * kStageBytes;
      const uint64_t dw_hi = descriptor(w_hi);
      const uint64_t dw_lo = descriptor(w_hi + kWPartBytes);
      const int accumulate = kt % kPromote != 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        wgmma_tf32(acc[h], fr[h][0], dw_lo, accumulate);
        if (kF32Rows) wgmma_tf32(acc[h], fr[h][1], dw_hi, 1);
        wgmma_tf32(acc[h], fr[h][0], dw_hi, 1);
      }
      wgmma_commit();
      if ((kt + 1) % kPromote == 0 || kt + 1 == n_ktiles) {
        // into the f32 sums (see the note at the top)
        wgmma_wait<0>();
        fence_operands(acc[0]);
        fence_operands(acc[1]);
        const bool first = kt < kPromote;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            float* s = sums + (h * 64 + i) * kThreads + t;
            *s = first ? acc[h][i] : *s + acc[h][i];
          }
        }
      } else {
        wgmma_wait<1>();
      }
    };

    for (int kt = 0; kt < kStages - 2; ++kt) load_stage(kt);
    uint32_t frag0[2][2][4], frag1[2][2][4];
    int kt = 0;
    for (; kt + 1 < n_ktiles; kt += 2) {
      step(kt, frag0);
      step(kt + 1, frag1);
    }
    if (kt < n_ktiles) step(kt, frag0);
    cp_async_wait<0>();

    // bias and relu on the thread's own sums: its value 4i + 2j + e of
    // half h is row 64h + 16*warp + g + 8j of its warpgroup, column
    // 8i + 2q + e
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = h0 + 8 * i + 2 * q + e;
        const float bias = col < H ? a.bias[col] : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float* s = sums + (h * 64 + 4 * i + 2 * j + e) * kThreads + t;
            *s = fmaxf(*s + bias, 0.f);
          }
        }
      }
    }
    __syncthreads();
    // the sum of row m, column c of the tile
    auto at = [&](int m, int c) {
      const int i = ((m >> 6) & 1) * 64 + 4 * (c >> 3) + 2 * ((m >> 3) & 1)
                    + (c & 1);
      const int thread = (m >> 7) * 128 + ((m >> 4) & 3) * 32 + (m & 7) * 4
                         + ((c >> 1) & 3);
      return sums[i * kThreads + thread];
    };

    // the reduce over each output row's rows in this chunk, in row order
    for (int p = t; p < nb * kNT; p += kThreads) {
      const int lb = p / kNT, col = p - lb * kNT;
      const int lo = max(lb * S, c0), hi = min(lb * S + S, c0 + rows_c);
      if (lo >= hi) continue;
      float v = at(lo - c0, col);
      for (int r = lo + 1; r < hi; ++r) {
        const float hv = at(r - c0, col);
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
int dispatch(const Args& a, const float* w, int reduce_max, int dropout,
             int want_x, cudaStream_t stream) {
  const dim3 grid((a.f_pad + 31) / 32, a.h_pad / 32);
  split_w_kernel<<<grid, dim3(32, 8), 0, stream>>>(
      w, const_cast<float*>(a.wt), a.F, a.H, a.f_pad, a.h_pad);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
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

// the widest copy (16, 8, 4 or 2 bytes, at most one stage's row) that
// divides the row and the table's alignment
int copy_unit(const void* feat, int F, int elem_bytes) {
  const long long row = static_cast<long long>(F) * elem_bytes;
  const uintptr_t base = reinterpret_cast<uintptr_t>(feat);
  for (int u = 16; u > 2; u /= 2) {
    if (u <= kKT * elem_bytes && row % u == 0 && base % u == 0) return u;
  }
  return 2;
}

Args make_args(const void* feat, int elem_bytes, const void* idx,
               const void* wt, const void* bias, void* out, void* x,
               long long n_rows, int B, int S, int F, int H,
               unsigned long long seed, unsigned int step, unsigned int tag,
               unsigned int threshold, float scale) {
  Args a;
  a.feat = feat;
  a.idx = static_cast<const int32_t*>(idx);
  a.wt = static_cast<const float*>(wt);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<float*>(out);
  a.x = static_cast<float*>(x);
  a.n_rows = n_rows;
  a.B = B;
  a.S = S;
  a.F = F;
  a.H = H;
  a.f_pad = (F + kKT - 1) / kKT * kKT;
  a.n_htiles = (H + kNT - 1) / kNT;
  a.h_pad = a.n_htiles * kNT;
  a.rows_per_block = S <= kMT ? kMT / S : 1;
  a.unit = copy_unit(feat, F, elem_bytes);
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
// wt is the scratch for w's split, [2, ceil(H/128)*128, ceil(F/8)*8]
// f32 (graphsage_gather_mlp_pool_wt_floats gives its size).
// reduce_max: 1 for max, 0 for mean. With dropout = 0 the seed, step,
// tag, threshold and scale are not read.
#define GRAPHSAGE_POOL_PARAMS                                               \
  const void *feat, const void *idx, const void *w, const void *bias,       \
      void *out, void *x, void *wt, long long n_rows, int B, int S, int F,  \
      int H, int reduce_max, int dropout, int want_x,                       \
      unsigned long long seed, unsigned int step, unsigned int tag,         \
      unsigned int threshold, float scale, void *stream
#define GRAPHSAGE_POOL_ARGS(ELEM_BYTES)                                     \
  make_args(feat, ELEM_BYTES, idx, wt, bias, out, x, n_rows, B, S, F, H,    \
            seed, step, tag, threshold, scale),                             \
      static_cast<const float*>(w), reduce_max, dropout, want_x,            \
      static_cast<cudaStream_t>(stream)

int graphsage_gather_mlp_pool_f32(GRAPHSAGE_POOL_PARAMS) {
  return dispatch<float>(GRAPHSAGE_POOL_ARGS(4));
}

int graphsage_gather_mlp_pool_bf16(GRAPHSAGE_POOL_PARAMS) {
  return dispatch<__nv_bfloat16>(GRAPHSAGE_POOL_ARGS(2));
}

#undef GRAPHSAGE_POOL_ARGS
#undef GRAPHSAGE_POOL_PARAMS

long long graphsage_gather_mlp_pool_wt_floats(int F, int H) {
  return 2LL * ((H + kNT - 1) / kNT * kNT) * ((F + kKT - 1) / kKT * kKT);
}

const char* graphsage_pool_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
