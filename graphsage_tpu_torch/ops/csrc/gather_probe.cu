// The gather-mean probe for Hopper (sm_90a): the designs of
// benchmarks/gather_probe.py, each the mean over S sampled rows
//
//   out[b, :] = (1/S) * sum_s feat[idx[b, s], :]   feat [N+1, F], idx [B, S]
//
// computed another way. Row N of the table is the dummy (zero) row.
//
//   K7a probe_gather_kernel<T, WAIT, MODE>: a ring of 1-D bulk copies
//       (cp.async.bulk, one per sample row) completing on mbarriers.
//       MODE kPlain with WAIT kSample, kRow or kTile replaces
//       _plain_kernel (:65), _bulkwait_kernel (:111) and
//       _tilewait_kernel (:161); MODE kHot (per-sample waits) replaces
//       _hot_kernel (:202); MODE kCompacted (per-row waits) replaces
//       _coldsw_kernel (:371), the cold half of kind "hc".
//   K7b probe_hotcount_kernel: (1/S) * C @ hot, C [128, K] the counts of
//       each id < K in a row, hot the bf16 hot block [K, F], on the
//       tensor cores (mma.sync m16n8k16 bf16, f32 accumulate); replaces
//       _hotcount_kernel (:443), the hot half of kind "hc".
//   K7c probe_hotmx_kernel: (1/S) * (C @ table[:K] + sum of the live
//       compacted cold slots), the hot part on the tensor cores in
//       2xTF32 while the cold rows arrive through K7a's ring; replaces
//       _hotmx_kernel (:275).
//
// What bounds them on the H100: memory bytes. At the probe's shape
// (B = 1024, S = 25, F = 640 f32, zipf(1.05) ids over N = 100k) a chunk
// draws ~7.7k distinct rows, 19.6 MB, of the 65.5 MB it gathers; with
// the 2.6 MB output that is ~6.7 us at 3.35 TB/s. The distinct rows fit
// the 50 MB L2, so the repeats of a hub row come from L2 whatever the
// design. K7b's and K7c's products are tiny (2 x B x K x F, 1.3 GFLOP at
// K = 1024, one or two passes).
//
// Design, and what became of the TPU's:
//   * the TPU keeps a ring of n_buf x tile_b x S whole rows in VMEM (1 MB
//     at the probe's shape); a block has 227 KB of shared memory. So a
//     block takes one column slice of FC columns: a slot holds tile_b x
//     W slices (W = S, or SW compacted slots), FC the widest divisor of
//     F whose ring fits (the wrapper picks it; 128 f32 columns at the
//     probe's tile_b 8, n_buf 2). Blocks walk a run of tiles of their
//     slice and keep n_buf - 1 tiles in flight, as the TPU's sequential
//     grid does;
//   * make_async_copy(...).start() is one cp.async.bulk of the sample's
//     slice (no tensor map: it is a 1-D copy of FC x elem bytes, which
//     must be a multiple of 16, from a 16-byte aligned address: the row
//     pitch F x elem must be a multiple of 16, which the wrapper checks);
//   * the TPU's semaphore counts bytes of completed copies; an mbarrier
//     counts arrivals and transaction bytes. The three wait variants
//     differ only in which mbarrier a copy completes on: one per sample
//     slot (kSample, expecting one slice), one per output row (kRow, S
//     slices), one per ring slot (kTile, tile_b x S slices). Every slot
//     of a tile arrives on its mbarrier every round (with its bytes, or
//     without for a hot sample, an unused compacted slot or a row past
//     B), so that every mbarrier's phase advances once a round and one
//     parity per round serves all;
//   * kHot: the TPU's VMEM-resident hot block (2.6 MB at K = 1024) does
//     not fit a block. Samples with id < K are read straight from the
//     table with 16-byte loads under an L2::evict_last policy, issued 8
//     samples at a time before they are summed; the cold ones come by
//     bulk copy with an L2::evict_first hint. Waits stay per sample,
//     taken for the cold samples only, as at :240-254;
//   * kCompacted: the wrapper compacts each row's cold ids to the left
//     (tail = dummy row N) and counts buckets of 4, nb [B]; the block
//     copies 4 x nb slots of a row and waits once per row. Slots from
//     4 x nb on are stale and are never read (the TPU selects them away);
//   * the reduction sums in f32 over the slots in order and scales by
//     1/S, as at :107-108. Row offsets are 64-bit; an out-of-range id
//     traps, as in K1;
//   * K7b: a block takes 128 output rows and 64 columns and keeps their
//     ids in shared memory; per chunk of 128 hot ids it builds the
//     counts there (a thread a sample, shared f32 atomics: adds of 1 are
//     exact in any order) and stages the hot chunk transposed; each warp
//     runs 16 rows x 64 columns on the tensor cores. Counts are at most
//     S <= 256, exact in bf16. mma.sync, not wgmma: a right and simple
//     first kernel;
//   * K7c: one TF32 pass rounds each hot row to 10 mantissa bits (2^-11
//     relative), far above the 1e-5 the port holds it to; the hot rows
//     are split into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna, as
//     ops/pool.py::tf32_split) in registers as they are loaded from the
//     table (L2), and C @ hi + C @ lo (C exact in TF32) is summed by
//     mma.sync m16n8k8 tf32. Splitting per block re-does the split for
//     every tile, but reads the hot rows once per tile instead of a
//     pre-split hi and lo twice, and needs no second launch. The tiles
//     take tile_b rows, a multiple of the MMA's 16; the warps share the
//     tile's 16-row x 8-column units and split the hot ids between them
//     when there are fewer than 8 units; a warp loads the B values of
//     256 hot ids a round before it multiplies; the partial sums meet in
//     shared memory in a fixed order, so results repeat bit for bit.
//
// Plain C interface for ctypes; each entry point returns
// cudaGetLastError() after its launch (or the error of a launch setting,
// or kErrSmemMismatch).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace {

using graphsage::to_float;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// a block's shared memory on the H100 (opt-in maximum)
constexpr size_t kSmemLimit = 232448;
// returned when the shared memory the wrapper sized (ops/gather_probe.py
// picks the column slice and sizes its ring) is not this file's layout
constexpr int kErrSmemMismatch = 100000;

enum Wait { kSample = 0, kRow = 1, kTile = 2 };
enum Mode { kPlain = 0, kHot = 1, kCompacted = 2 };

// K7b's tile
constexpr int kHotTile = 128;   // output rows per block (the JAX HOT_TILE)
constexpr int kHotNT = 64;      // columns per block
constexpr int kHotKC = 128;     // hot ids per chunk
constexpr int kHotPitch = kHotKC + 8;  // bf16 elements a hot_t row
constexpr int kHotCPitch = kHotKC + 4;  // f32 elements a counts row
// the hot chunk's (k, k + 1) pairs a thread stages
constexpr int kHotStage = kHotNT * (kHotKC / 2) / kThreads;
static_assert(kHotStage * kThreads == kHotNT * (kHotKC / 2), "staging");
// K7c: hot ids per warp and round
constexpr int kMxKC = 256;
// K7a hot: the table loads a thread issues before it sums them
constexpr int kHotLoads = 8;

struct Args {
  const void* feat;         // [n_rows, F]
  const int32_t* idx;       // [B, W]: the ids, or the compacted cold ids
  const int32_t* nb;        // [B] buckets of 4 live slots (compacted)
  const int32_t* raw_idx;   // [B, S] the ids (K7c's counts)
  float* out;               // [B, F]
  int64_t n_rows;
  int B, W, S, F, FC, tile_b, n_buf, K;
  int n_tiles, tiles_per_block;
  float inv_s;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 state;\n"
               "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("{\n.reg .b64 state;\n"
               "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;"
               "\n}\n" :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}

// generic-proxy accesses of shared memory ordered before the async
// proxy's (the bulk copies that refill a slot the threads just read)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void bulk_copy_hint(uint32_t dst, const void* src,
                                               uint32_t bytes, uint32_t bar,
                                               uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar), "l"(policy) : "memory");
}

__device__ __forceinline__ uint64_t policy_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t policy_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ uint4 ld_hint(const void* src, uint64_t policy) {
  uint4 v;
  asm volatile("ld.global.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(src), "l"(policy));
  return v;
}

// acc[k] += the k-th element of 16 bytes of T
template <typename T>
__device__ __forceinline__ void add16(float* acc, const uint4& raw) {
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int k = 0; k < 16 / static_cast<int>(sizeof(T)); ++k) {
    acc[k] += to_float(v[k]);
  }
}

__device__ __forceinline__ float tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

// d += a * b: m16n8k8, tf32 operands, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b: m16n8k16, bf16 operands, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------------------------------------ the ring

// Shared memory of the ring, in this order: n_buf slots of tile_b x W
// slices of FC elements; the mbarriers; each slot's ids [tile_b x W] and
// live buckets [tile_b]; rounded up to 16 bytes for what follows.
// ops/gather_probe.py::ring_bytes sizes it to pick the column slice and
// passes its size to the launch, which refuses one that differs.
struct Ring {
  unsigned char* slots;
  uint32_t slots_addr;
  uint32_t bars_addr;
  int32_t* ids;
  int32_t* nbs;
  int bars_per_slot;
  size_t end;   // bytes used
};

template <int WAIT>
__host__ __device__ int bars_per_slot(int tile_b, int W) {
  return WAIT == kSample ? tile_b * W : (WAIT == kRow ? tile_b : 1);
}

template <int WAIT>
__host__ __device__ size_t ring_bytes(int n_buf, int tile_b, int W,
                                      size_t slice_bytes) {
  const size_t slot_rows = static_cast<size_t>(tile_b) * W;
  const size_t bytes =
      n_buf * slot_rows * slice_bytes
      + 8 * static_cast<size_t>(n_buf) * bars_per_slot<WAIT>(tile_b, W)
      + 4 * n_buf * slot_rows + 4 * static_cast<size_t>(n_buf) * tile_b;
  return (bytes + 15) & ~static_cast<size_t>(15);
}

template <int WAIT>
__device__ Ring make_ring(unsigned char* smem, const Args& a,
                          uint32_t slice_bytes) {
  Ring r;
  const int slot_rows = a.tile_b * a.W;
  r.bars_per_slot = bars_per_slot<WAIT>(a.tile_b, a.W);
  r.slots = smem;
  r.slots_addr = smem_addr(smem);
  size_t off = static_cast<size_t>(a.n_buf) * slot_rows * slice_bytes;
  r.bars_addr = r.slots_addr + static_cast<uint32_t>(off);
  off += 8 * static_cast<size_t>(a.n_buf) * r.bars_per_slot;
  r.ids = reinterpret_cast<int32_t*>(smem + off);
  off += 4 * static_cast<size_t>(a.n_buf) * slot_rows;
  r.nbs = reinterpret_cast<int32_t*>(smem + off);
  off += 4 * static_cast<size_t>(a.n_buf) * a.tile_b;
  r.end = (off + 15) & ~static_cast<size_t>(15);
  const uint32_t count = WAIT == kSample ? 1u
                         : (WAIT == kRow ? static_cast<uint32_t>(a.W)
                                         : static_cast<uint32_t>(slot_rows));
  for (int i = threadIdx.x; i < a.n_buf * r.bars_per_slot; i += blockDim.x) {
    mbar_init(r.bars_addr + 8 * i, count);
  }
  fence_barrier_init();
  __syncthreads();
  return r;
}

__device__ __forceinline__ uint32_t bar_of(const Ring& r, int slot, int i) {
  return r.bars_addr + 8 * (slot * r.bars_per_slot + i);
}

// make_async_copy(...).start() for every slot of tile `tile` into ring
// slot `slot`: each thread takes slots j of the tile, loads the id,
// records it, and either arrives with the copy's bytes and issues the
// copy or arrives without bytes
template <typename T, int WAIT, int MODE>
__device__ void issue_tile(const Args& a, const Ring& r, int tile, int slot,
                           int col0, uint32_t slice_bytes,
                           uint64_t cold_policy) {
  const T* feat = static_cast<const T*>(a.feat);
  const int slot_rows = a.tile_b * a.W;
  const int64_t row0 = static_cast<int64_t>(tile) * a.tile_b;
  fence_proxy_async();
  for (int j = threadIdx.x; j < slot_rows; j += blockDim.x) {
    const int rr = j / a.W, s = j - rr * a.W;
    const int64_t b = row0 + rr;
    int32_t id = 0;
    bool copy = false;
    if (b < a.B) {
      id = a.idx[b * a.W + s];
      if (id < 0 || id >= a.n_rows) __trap();
      if (MODE == kHot) {
        copy = id >= a.K;
      } else if (MODE == kCompacted) {
        const int nb = a.nb[b];
        if (nb < 0 || 4 * nb > a.W) __trap();
        copy = s < 4 * nb;
        if (s == 0) r.nbs[slot * a.tile_b + rr] = nb;
      } else {
        copy = true;
      }
    } else if (MODE == kCompacted && s == 0) {
      r.nbs[slot * a.tile_b + rr] = 0;
    }
    r.ids[slot * slot_rows + j] = id;
    const uint32_t bar =
        bar_of(r, slot, WAIT == kSample ? j : (WAIT == kRow ? rr : 0));
    if (copy) {
      mbar_arrive_expect_tx(bar, slice_bytes);
      const uint32_t dst =
          r.slots_addr + static_cast<uint32_t>(slot * slot_rows + j)
                             * slice_bytes;
      const T* src = feat + static_cast<int64_t>(id) * a.F + col0;
      if (MODE == kHot) {
        bulk_copy_hint(dst, src, slice_bytes, bar, cold_policy);
      } else {
        bulk_copy(dst, src, slice_bytes, bar);
      }
    } else {
      mbar_arrive(bar);
    }
  }
}

// the block's run of tiles: [tile0, tile0 + n_my)
__device__ __forceinline__ void block_tiles(const Args& a, int& tile0,
                                            int& n_my) {
  tile0 = blockIdx.y * a.tiles_per_block;
  n_my = min(a.tiles_per_block, a.n_tiles - tile0);
}

// ---------------------------------------------------------------- K7a

template <typename T, int WAIT, int MODE>
__global__ void __launch_bounds__(kThreads)
probe_gather_kernel(const Args a) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t slice_bytes = a.FC * sizeof(T);
  const Ring r = make_ring<WAIT>(smem, a, slice_bytes);
  const int col0 = blockIdx.x * a.FC;
  int tile0, n_my;
  block_tiles(a, tile0, n_my);
  const T* feat = static_cast<const T*>(a.feat);
  const int slot_rows = a.tile_b * a.W;
  const int vpr = a.FC / VEC;   // 16-byte vectors in a row's slice
  const uint64_t cold_policy = MODE == kHot ? policy_evict_first() : 0;
  const uint64_t hot_policy = MODE == kHot ? policy_evict_last() : 0;

  for (int k = 0; k < a.n_buf - 1 && k < n_my; ++k) {
    issue_tile<T, WAIT, MODE>(a, r, tile0 + k, k, col0, slice_bytes,
                              cold_policy);
  }
  for (int i = 0; i < n_my; ++i) {
    const int ahead = i + a.n_buf - 1;
    if (ahead < n_my) {
      issue_tile<T, WAIT, MODE>(a, r, tile0 + ahead, ahead % a.n_buf, col0,
                                slice_bytes, cold_policy);
    }
    __syncthreads();   // the slot's ids and buckets are written
    const int slot = i % a.n_buf;
    const uint32_t parity = (i / a.n_buf) & 1;
    const int64_t row0 = static_cast<int64_t>(tile0 + i) * a.tile_b;
    if (WAIT == kTile) mbar_wait(bar_of(r, slot, 0), parity);
    for (int p = threadIdx.x; p < a.tile_b * vpr; p += blockDim.x) {
      const int rr = p / vpr, v = p - rr * vpr;
      const int64_t b = row0 + rr;
      if (b >= a.B) continue;
      if (WAIT == kRow) mbar_wait(bar_of(r, slot, rr), parity);
      float acc[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
      const int n_live =
          MODE == kCompacted ? 4 * r.nbs[slot * a.tile_b + rr] : a.W;
      if constexpr (MODE == kHot) {
        // groups of kHotLoads samples: the group's hot loads are issued
        // before any is summed, the cold ones wait for their copies
        const int32_t* ids = r.ids + slot * slot_rows + rr * a.W;
        for (int s0 = 0; s0 < n_live; s0 += kHotLoads) {
          uint4 hv[kHotLoads];
#pragma unroll
          for (int u = 0; u < kHotLoads; ++u) {
            const int s = s0 + u;
            if (s < n_live && ids[s] < a.K) {
              hv[u] = ld_hint(feat + static_cast<int64_t>(ids[s]) * a.F
                                  + col0 + v * VEC, hot_policy);
            }
          }
#pragma unroll
          for (int u = 0; u < kHotLoads; ++u) {
            const int j = rr * a.W + s0 + u;
            if (s0 + u >= n_live) break;
            if (ids[s0 + u] < a.K) {
              add16<T>(acc, hv[u]);
            } else {
              mbar_wait(bar_of(r, slot, j), parity);
              add16<T>(acc, *reinterpret_cast<const uint4*>(
                  r.slots + static_cast<size_t>(slot * slot_rows + j)
                                * slice_bytes + 16 * v));
            }
          }
        }
      } else {
        // (one loop for the other modes: it measured faster than the
        // grouped one for them)
        for (int s = 0; s < n_live; ++s) {
          const int j = rr * a.W + s;
          if (WAIT == kSample) mbar_wait(bar_of(r, slot, j), parity);
          const uint4 raw = *reinterpret_cast<const uint4*>(
              r.slots + static_cast<size_t>(slot * slot_rows + j)
                            * slice_bytes + 16 * v);
          add16<T>(acc, raw);
        }
      }
      float* o = a.out + b * a.F + col0 + v * VEC;
#pragma unroll
      for (int k = 0; k < VEC; k += 4) {
        *reinterpret_cast<float4*>(o + k) =
            make_float4(acc[k] * a.inv_s, acc[k + 1] * a.inv_s,
                        acc[k + 2] * a.inv_s, acc[k + 3] * a.inv_s);
      }
    }
    __syncthreads();   // the slot is free for the copies of tile i + n_buf
  }
}

// ---------------------------------------------------------------- K7b

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// K7b's shared memory: the tile's ids [128][S], a chunk's counts [128]
// [kHotCPitch] f32, the hot chunk transposed [kHotNT][kHotPitch] bf16
__host__ __device__ inline size_t hotcount_bytes(int S) {
  return 4 * static_cast<size_t>(kHotTile) * S
         + 4 * static_cast<size_t>(kHotTile) * kHotCPitch
         + 2 * static_cast<size_t>(kHotNT) * kHotPitch;
}

__global__ void __launch_bounds__(kThreads)
probe_hotcount_kernel(const int32_t* __restrict__ idx,
                      const __nv_bfloat16* __restrict__ hot,
                      float* __restrict__ out, int B, int S, int F, int K,
                      float inv_s) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* ids = reinterpret_cast<int32_t*>(smem);
  float* cnt = reinterpret_cast<float*>(smem + 4 * kHotTile * S);
  __nv_bfloat16* hot_t =
      reinterpret_cast<__nv_bfloat16*>(cnt + kHotTile * kHotCPitch);
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, q = lane & 3;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * kHotTile;
  const int n0 = blockIdx.x * kHotNT;
  const uint16_t* hot16 = reinterpret_cast<const uint16_t*>(hot);
  const int n_pairs = kHotTile * S;
  for (int p = t; p < n_pairs; p += kThreads) {
    ids[p] = row0 + p / S < B ? idx[row0 * S + p] : -1;
  }
  float acc[kHotNT / 8][4];
#pragma unroll
  for (int n = 0; n < kHotNT / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }

  for (int k0 = 0; k0 < K; k0 += kHotKC) {
    for (int i = t; i < kHotTile * kHotCPitch / 4; i += kThreads) {
      reinterpret_cast<float4*>(cnt)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    // pairs of hot rows (k, k + 1) of one column, packed as the B
    // fragment wants them; all of a thread's loads issued before its
    // stores
    uint32_t lo[kHotStage], hi[kHotStage];
#pragma unroll
    for (int i = 0; i < kHotStage; ++i) {
      const int p = t + i * kThreads;
      const int k = k0 + 2 * (p / kHotNT), col = n0 + p % kHotNT;
      lo[i] = col < F && k < K ? hot16[static_cast<int64_t>(k) * F + col]
                               : 0u;
      hi[i] = col < F && k + 1 < K
                  ? hot16[static_cast<int64_t>(k + 1) * F + col] : 0u;
    }
#pragma unroll
    for (int i = 0; i < kHotStage; ++i) {
      const int p = t + i * kThreads;
      *reinterpret_cast<uint32_t*>(hot_t + (p % kHotNT) * kHotPitch
                                   + 2 * (p / kHotNT)) = lo[i] | (hi[i] << 16);
    }
    __syncthreads();
    // the chunk's counts: one thread a sample; adds of 1.0 are exact in
    // any order, so the counts repeat bit for bit
    const int k_end = min(k0 + kHotKC, K);
    for (int p = t; p < n_pairs; p += kThreads) {
      const int id = ids[p];
      if (id >= k0 && id < k_end) {
        atomicAdd(cnt + (p / S) * kHotCPitch + (id - k0), 1.f);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kHotKC; kk += 16) {
      const float* ca = cnt + (warp * 16 + g) * kHotCPitch + kk + 2 * q;
      uint32_t af[4];
      af[0] = pack_bf16(ca[0], ca[1]);
      af[1] = pack_bf16(ca[8 * kHotCPitch], ca[8 * kHotCPitch + 1]);
      af[2] = pack_bf16(ca[8], ca[9]);
      af[3] = pack_bf16(ca[8 * kHotCPitch + 8], ca[8 * kHotCPitch + 9]);
#pragma unroll
      for (int n = 0; n < kHotNT / 8; ++n) {
        const __nv_bfloat16* hb = hot_t + (8 * n + g) * kHotPitch + kk + 2 * q;
        mma_bf16(acc[n], af, *reinterpret_cast<const uint32_t*>(hb),
                 *reinterpret_cast<const uint32_t*>(hb + 8));
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int n = 0; n < kHotNT / 8; ++n) {
    const int col = n0 + 8 * n + 2 * q;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t row = row0 + warp * 16 + g + 8 * h;
      if (row >= B) continue;
      float* o = out + row * F + col;
      if (col < F) o[0] = acc[n][2 * h] * inv_s;
      if (col + 1 < F) o[1] = acc[n][2 * h + 1] * inv_s;
    }
  }
}

// ---------------------------------------------------------------- K7c

// K7c's work split: the tile's units of 16 rows x 8 columns, and the
// parts of each round's hot ids that the warps share when there are
// fewer than 8 units (ops/gather_probe.py sizes shared memory from the
// same split; the launch refuses a size that differs)
__host__ __device__ __forceinline__ int mx_units(int tile_b, int FC) {
  return (tile_b / 16) * (FC / 8);
}

__host__ __device__ __forceinline__ int mx_parts(int tile_b, int FC) {
  const int u = mx_units(tile_b, FC);
  return u >= kWarps ? 1 : kWarps / u;
}

// K7c's shared memory: K7a's row-wait ring, a round's counts [tile_b]
// [parts x kMxKC + 4] f32, the warps' partial sums [parts][tile_b][FC]
// f32 and the tile's ids [tile_b][S]
__host__ __device__ size_t hotmx_bytes(int n_buf, int tile_b, int W, int FC,
                                       int S) {
  const int kp = mx_parts(tile_b, FC);
  return ring_bytes<kRow>(n_buf, tile_b, W, 4 * static_cast<size_t>(FC))
         + 4 * static_cast<size_t>(tile_b) * (kp * kMxKC + 4)
         + 4 * static_cast<size_t>(kp) * tile_b * FC
         + 4 * static_cast<size_t>(tile_b) * S;
}

__global__ void __launch_bounds__(kThreads)
probe_hotmx_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t slice_bytes = a.FC * 4;
  const Ring r = make_ring<kRow>(smem, a, slice_bytes);
  const int units = mx_units(a.tile_b, a.FC);
  const int parts = mx_parts(a.tile_b, a.FC);
  const int cw = parts * kMxKC;          // hot ids a round
  const int cpitch = cw + 4;             // counts row pitch, in floats
  float* counts = reinterpret_cast<float*>(smem + r.end);
  float* partial = counts + static_cast<size_t>(a.tile_b) * cpitch;
  int32_t* sids = reinterpret_cast<int32_t*>(
      partial + static_cast<size_t>(parts) * a.tile_b * a.FC);
  const int col0 = blockIdx.x * a.FC;
  int tile0, n_my;
  block_tiles(a, tile0, n_my);
  const float* feat = static_cast<const float*>(a.feat);
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, q = lane & 3;
  const bool active = warp < units * parts;
  const int unit = warp % units, part = warp / units;
  const int mt = unit / (a.FC / 8), nt = unit % (a.FC / 8);
  const int slot_rows = a.tile_b * a.W;
  const int vpr = a.FC / 4;

  for (int k = 0; k < a.n_buf - 1 && k < n_my; ++k) {
    issue_tile<float, kRow, kCompacted>(a, r, tile0 + k, k, col0,
                                        slice_bytes, 0);
  }
  for (int i = 0; i < n_my; ++i) {
    const int ahead = i + a.n_buf - 1;
    if (ahead < n_my) {
      issue_tile<float, kRow, kCompacted>(a, r, tile0 + ahead,
                                          ahead % a.n_buf, col0, slice_bytes,
                                          0);
    }
    const int slot = i % a.n_buf;
    const uint32_t parity = (i / a.n_buf) & 1;
    const int64_t row0 = static_cast<int64_t>(tile0 + i) * a.tile_b;

    // the hot part, while the cold copies fly: counts @ hot, 2xTF32
    for (int p = t; p < a.tile_b * a.S; p += kThreads) {
      int32_t id = -1;
      if (row0 + p / a.S < a.B) {
        id = a.raw_idx[row0 * a.S + p];
        if (id < 0 || id >= a.n_rows) __trap();
      }
      sids[p] = id;
    }
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < a.K; k0 += cw) {
      for (int e = t; e < a.tile_b * cpitch / 4; e += kThreads) {
        reinterpret_cast<float4*>(counts)[e] =
            make_float4(0.f, 0.f, 0.f, 0.f);
      }
      __syncthreads();
      // one thread a sample; adds of 1.0 are exact in any order
      const int k_end = min(k0 + cw, a.K);
      for (int p = t; p < a.tile_b * a.S; p += kThreads) {
        const int32_t id = sids[p];
        if (id >= k0 && id < k_end) {
          atomicAdd(counts + (p / a.S) * cpitch + (id - k0), 1.f);
        }
      }
      __syncthreads();
      if (active) {
        // the warp's part: its kMxKC hot rows' B values loaded together
        // (0 past K, where the counts are 0 too), then the k-steps
        const int kb = k0 + part * kMxKC;
        const float* ca = counts + (mt * 16 + g) * cpitch + part * kMxKC + q;
        const float* hb = feat + col0 + nt * 8 + g;
        float v[kMxKC / 4];
#pragma unroll
        for (int j = 0; j < kMxKC / 8; ++j) {
          const int k = kb + 8 * j + q;
          v[2 * j] = k < a.K ? hb[static_cast<int64_t>(k) * a.F] : 0.f;
          v[2 * j + 1] =
              k + 4 < a.K ? hb[static_cast<int64_t>(k + 4) * a.F] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < kMxKC / 8; ++j) {
          uint32_t af[4];
          af[0] = __float_as_uint(ca[8 * j]);
          af[1] = __float_as_uint(ca[8 * j + 8 * cpitch]);
          af[2] = __float_as_uint(ca[8 * j + 4]);
          af[3] = __float_as_uint(ca[8 * j + 8 * cpitch + 4]);
          const float h0 = tf32_rna(v[2 * j]), h1 = tf32_rna(v[2 * j + 1]);
          mma_tf32(acc, af, __float_as_uint(h0), __float_as_uint(h1));
          mma_tf32(acc, af, __float_as_uint(tf32_rna(v[2 * j] - h0)),
                   __float_as_uint(tf32_rna(v[2 * j + 1] - h1)));
        }
      }
      __syncthreads();   // the counts are rebuilt next round
    }
    if (active) {
      float* pr = partial + (static_cast<size_t>(part) * a.tile_b + mt * 16
                             + g) * a.FC + nt * 8 + 2 * q;
      *reinterpret_cast<float2*>(pr) = make_float2(acc[0], acc[1]);
      *reinterpret_cast<float2*>(pr + 8 * a.FC) = make_float2(acc[2], acc[3]);
    }
    __syncthreads();

    // the cold part, then hot + cold
    for (int p = t; p < a.tile_b * vpr; p += kThreads) {
      const int rr = p / vpr, v = p - rr * vpr;
      const int64_t b = row0 + rr;
      if (b >= a.B) continue;
      mbar_wait(bar_of(r, slot, rr), parity);
      float cold[4] = {0.f, 0.f, 0.f, 0.f};
      const int n_live = 4 * r.nbs[slot * a.tile_b + rr];
      for (int s = 0; s < n_live; ++s) {
        const int j = rr * a.W + s;
        add16<float>(cold, *reinterpret_cast<const uint4*>(
            r.slots + static_cast<size_t>(slot * slot_rows + j) * slice_bytes
            + 16 * v));
      }
      float hot[4] = {0.f, 0.f, 0.f, 0.f};
      for (int kp = 0; kp < parts; ++kp) {
        const float4 h = *reinterpret_cast<const float4*>(
            partial + (static_cast<size_t>(kp) * a.tile_b + rr) * a.FC
            + 4 * v);
        hot[0] += h.x; hot[1] += h.y; hot[2] += h.z; hot[3] += h.w;
      }
      *reinterpret_cast<float4*>(a.out + b * a.F + col0 + 4 * v) =
          make_float4((hot[0] + cold[0]) * a.inv_s,
                      (hot[1] + cold[1]) * a.inv_s,
                      (hot[2] + cold[2]) * a.inv_s,
                      (hot[3] + cold[3]) * a.inv_s);
    }
    __syncthreads();   // the slot and the partials are free
  }
}

// ------------------------------------------------------------- launches

// fills the grid: blocks of one column slice walk runs of tiles, as many
// runs as keep every SM busy at the kernel's occupancy
template <typename Kernel>
int launch_ring(Kernel kernel, Args a, size_t smem, void* stream) {
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, n_sm = 0, occ = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads,
                                                      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (occ < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int n_slices = a.F / a.FC;
  a.n_tiles = (a.B + a.tile_b - 1) / a.tile_b;
  const int want = (n_sm * occ + n_slices - 1) / n_slices;
  const int runs = max(1, min(a.n_tiles, want));
  a.tiles_per_block = (a.n_tiles + runs - 1) / runs;
  const int groups = (a.n_tiles + a.tiles_per_block - 1) / a.tiles_per_block;
  kernel<<<dim3(n_slices, groups), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool ring_shape_ok(const Args& a, int elem) {
  return a.B > 0 && a.W > 0 && a.tile_b > 0 && a.n_buf > 0 && a.FC > 0
         && a.F % a.FC == 0 && (a.FC * elem) % 16 == 0
         && (static_cast<int64_t>(a.F) * elem) % 16 == 0;
}

template <typename T>
int launch_gather(Args a, int wait, int mode, size_t smem, void* stream) {
  if (!ring_shape_ok(a, sizeof(T))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t slice = a.FC * sizeof(T);
  void (*kernel)(const Args) = nullptr;
  size_t need = 0;
  if (mode == kPlain && wait == kSample) {
    kernel = probe_gather_kernel<T, kSample, kPlain>;
    need = ring_bytes<kSample>(a.n_buf, a.tile_b, a.W, slice);
  } else if (mode == kPlain && wait == kRow) {
    kernel = probe_gather_kernel<T, kRow, kPlain>;
    need = ring_bytes<kRow>(a.n_buf, a.tile_b, a.W, slice);
  } else if (mode == kPlain && wait == kTile) {
    kernel = probe_gather_kernel<T, kTile, kPlain>;
    need = ring_bytes<kTile>(a.n_buf, a.tile_b, a.W, slice);
  } else if (mode == kHot && wait == kSample) {
    kernel = probe_gather_kernel<T, kSample, kHot>;
    need = ring_bytes<kSample>(a.n_buf, a.tile_b, a.W, slice);
  } else if (mode == kCompacted && wait == kRow) {
    kernel = probe_gather_kernel<T, kRow, kCompacted>;
    need = ring_bytes<kRow>(a.n_buf, a.tile_b, a.W, slice);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem != need) return kErrSmemMismatch;
  return launch_ring(kernel, a, smem, stream);
}

Args ring_args(const void* feat, const void* idx, const void* nb, void* out,
               long long n_rows, int B, int W, int S, int F, int FC,
               int tile_b, int n_buf, int K) {
  Args a{};
  a.feat = feat;
  a.idx = static_cast<const int32_t*>(idx);
  a.nb = static_cast<const int32_t*>(nb);
  a.out = static_cast<float*>(out);
  a.n_rows = n_rows;
  a.B = B; a.W = W; a.S = S; a.F = F; a.FC = FC;
  a.tile_b = tile_b; a.n_buf = n_buf; a.K = K;
  a.inv_s = 1.f / static_cast<float>(S);
  return a;
}

}  // namespace

extern "C" {

// K7a. idx [B, W] (W = S; compacted: the cold ids [B, SW] with nb [B],
// else nb unused); wait 0 sample, 1 row, 2 tile; mode 0 plain, 1 hot
// (ids < K read from the table), 2 compacted. FC divides F, FC x elem
// and F x elem are multiples of 16; smem is the ring's bytes.
int graphsage_probe_gather_f32(const void* feat, const void* idx,
                               const void* nb, void* out, long long n_rows,
                               int B, int W, int S, int F, int FC,
                               int tile_b, int n_buf, int K, int wait,
                               int mode, long long smem, void* stream) {
  return launch_gather<float>(
      ring_args(feat, idx, nb, out, n_rows, B, W, S, F, FC, tile_b, n_buf,
                K), wait, mode, static_cast<size_t>(smem), stream);
}

int graphsage_probe_gather_bf16(const void* feat, const void* idx,
                                const void* nb, void* out, long long n_rows,
                                int B, int W, int S, int F, int FC,
                                int tile_b, int n_buf, int K, int wait,
                                int mode, long long smem, void* stream) {
  return launch_gather<__nv_bfloat16>(
      ring_args(feat, idx, nb, out, n_rows, B, W, S, F, FC, tile_b, n_buf,
                K), wait, mode, static_cast<size_t>(smem), stream);
}

// K7b. idx [B, S] with B a multiple of 128, hot [K, F] bf16, out [B, F]
int graphsage_probe_hotcount(const void* idx, const void* hot, void* out,
                             int B, int S, int F, int K, void* stream) {
  if (B <= 0 || B % kHotTile != 0 || S <= 0 || F <= 0 || K < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = hotcount_bytes(S);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      probe_hotcount_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((F + kHotNT - 1) / kHotNT, B / kHotTile);
  probe_hotcount_kernel<<<grid, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx),
      static_cast<const __nv_bfloat16*>(hot), static_cast<float*>(out), B,
      S, F, K, 1.f / static_cast<float>(S));
  return static_cast<int>(cudaGetLastError());
}

// K7c. feat [n_rows, F] f32 (its first K rows are the hot block), idx
// [B, S], idx_dma [B, SW] and nb [B] its stable cold-first compaction;
// tile_b a multiple of 16, FC a multiple of 8 dividing F with at most 8
// units of 16 x 8; smem is hotmx_bytes
int graphsage_probe_hotmx(const void* feat, const void* idx,
                          const void* idx_dma, const void* nb, void* out,
                          long long n_rows, int B, int S, int SW, int F,
                          int FC, int tile_b, int n_buf, int K,
                          long long smem, void* stream) {
  Args a = ring_args(feat, idx_dma, nb, out, n_rows, B, SW, S, F, FC, tile_b,
                     n_buf, K);
  a.raw_idx = static_cast<const int32_t*>(idx);
  if (!ring_shape_ok(a, 4) || tile_b % 16 != 0 || FC % 8 != 0
      || mx_units(tile_b, FC) > kWarps || K < 0 || K > n_rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (static_cast<size_t>(smem) != hotmx_bytes(n_buf, tile_b, SW, FC, S)) {
    return kErrSmemMismatch;
  }
  return launch_ring(probe_hotmx_kernel, a, static_cast<size_t>(smem),
                     stream);
}

const char* graphsage_cuda_error_string(int err) {
  if (err == kErrSmemMismatch) {
    return "the shared memory the wrapper sized (ops/gather_probe.py) is "
           "not the kernel's layout";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
