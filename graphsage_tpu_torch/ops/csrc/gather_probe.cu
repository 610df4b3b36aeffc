// The gather-mean probe for Hopper (sm_90a): the designs of
// benchmarks/gather_probe.py, each the mean over S sampled rows
//
//   out[b, :] = (1/S) * sum_s feat[idx[b, s], :]   feat [N+1, F], idx [B, S]
//
// computed another way. Row N of the table is the dummy (zero) row.
//
//   K7a probe_gather_kernel<T, WAIT, MODE>: a ring of 1-D bulk copies
//       (cp.async.bulk, one per sample row) that producer warps issue and
//       consumer warps sum, on full and empty mbarriers.
//       MODE kPlain with WAIT kSample, kRow or kTile replaces
//       _plain_kernel (:65), _bulkwait_kernel (:111) and
//       _tilewait_kernel (:161); MODE kHot (per-sample waits) replaces
//       _hot_kernel (:202); MODE kCompacted (per-row waits) replaces
//       _coldsw_kernel (:371), the cold half of kind "hc".
//   K7b probe_hotcount_kernel<TMA>: (1/S) * C @ hot, C [B, K] the counts
//       of each id < K in a row, hot the bf16 hot block [K, F], on the
//       tensor cores (wgmma m64n64k16 bf16, f32 accumulate); replaces
//       _hotcount_kernel (:443), the hot half of kind "hc".
//   K7c probe_hotmx_kernel<R>: (1/S) * (C @ table[:K] + the row's cold
//       samples, id >= K), the hot part on the tensor cores in 2xTF32
//       (wgmma m64nRk8) while other warps sum the cold rows straight
//       from the table; replaces _hotmx_kernel (:275) with the stable
//       cold-first compaction the JAX probe runs before it.
//
// What bounds them on the H100: memory bytes. At the probe's shape
// (B = 1024, S = 25, F = 640 f32, zipf(1.05) ids over N = 100k) a chunk
// draws ~7.7k distinct rows, 19.6 MB, of the 65.5 MB it gathers; with
// the 2.6 MB output that is ~6.7 us at 3.35 TB/s. The distinct rows fit
// the 50 MB L2, so the repeats of a hub row come from L2 whatever the
// design. K7b's and K7c's dense products do more work than the function
// needs (2 x B x K x F, 1.3 GFLOP at K = 1024, one pass in bf16 or two
// in TF32): at the tensor cores' peak that is 1.4 us for K7b and 5.4 us
// for K7c (21.7 us at K = 4096), the floor of these designs.
//
// Design, and what became of the TPU's:
//   * K7a: the TPU keeps a ring of n_buf x tile_b x S whole rows in VMEM
//     (1 MB at the probe's shape) and runs its grid in order. What a ring
//     of bulk copies can do on Hopper that K1's plain loads cannot: a copy
//     moves a row's slice with one instruction and no registers, and a
//     block can keep most of its 227 KB of shared memory in flight, where
//     K1's threads hold five 16-byte loads each. K7a is built on both,
//     warp-specialised on full and empty mbarriers in place of
//     __syncthreads: kRingProducers producer warps fill a ring of n_buf
//     stages, kRingConsumers consumer warps sum them. A stage holds tile_b
//     output rows x W slots (W = S, or SW compacted slots) of one column
//     slice of FC columns. The wrapper's default is 3 stages of whole rows
//     of about 64 KB (tile_b 1 for the probe's f32 rows, 2 for bf16): an
//     id is loaded and checked once and a copy moves a whole row (2,560
//     or 1,280 bytes); narrower slices multiply the ids, copies and
//     stages for the same bytes;
//   * a persistent grid: as many blocks as the SMs hold, each walking a run
//     of items (a tile x a slice), slice-major, within one of each other;
//   * the producers, a thread a slot (slot j to lane j / P of warp j % P,
//     so that the two warps' copies go out side by side): a thread holds
//     the ids of its first slot kAhead items ahead in registers, waits for
//     the stage to be free, checks each id and issues one cp.async.bulk of
//     the slot's slice (make_async_copy(...).start(); a 1-D copy of FC x
//     elem bytes, a multiple of 16, from a 16-byte aligned address: the
//     row pitch F x elem must be a multiple of 16, which the wrapper
//     checks); each copy is issued through the uniform datapath one at a
//     time, so one warp alone could not keep the ring full;
//   * the TPU's semaphore counts bytes of completed copies; an mbarrier
//     counts arrivals and transaction bytes. The three wait variants
//     differ only in which mbarrier a copy completes on and the consumers
//     wait on: one per slot (kSample, one slice), one per output row
//     (kRow, W slices), one per stage (kTile, tile_b x W slices). Every
//     slot of a stage arrives on its mbarrier every round (with its bytes,
//     or without for a hot sample, an unused compacted slot or a row past
//     B), so that every mbarrier's phase advances once a round and one
//     parity a round serves all;
//   * the consumers, in kConsumerGroups groups that take the items in
//     turn (two items' loads in flight at once), a thread a 16-byte
//     vector of a row's slice: they sum the row's slots from shared memory
//     16 at a time (their loads issued before any is summed; a warp's 32
//     16-byte loads on 512 contiguous bytes) and store the mean; per-sample
//     waits test a group's mbarriers together (mbarrier.test_wait) and
//     wait one by one only where a copy has not landed. Then each warp of
//     the group arrives on the stage's empty mbarrier, which the
//     producers wait on before they refill the stage;
//   * kHot: the TPU's VMEM-resident hot block (2.6 MB at K = 1024) does
//     not fit a block. Samples with id < K are read straight from the
//     table by the consumers with 16-byte loads under an L2::evict_last
//     policy, a whole row's (up to 32 samples) issued before any is
//     summed: those loads wait on the L2 far longer than the cold slots
//     wait in shared memory. The cold ones come by bulk copy with an
//     L2::evict_first hint, waited for per sample; the producers write
//     the stage's ids for the consumers;
//   * kCompacted: the wrapper compacts each row's cold ids to the left
//     (tail = dummy row N) and counts buckets of 4, nb [B]; the producers
//     copy 4 x nb slots of a row and write nb for the consumers, which
//     wait once per row. Slots from 4 x nb on are stale and are never
//     read (the TPU selects them away);
//   * the reduction sums in f32 over the slots in order and scales by
//     1/S, as at :107-108. Row offsets are 64-bit; an out-of-range id
//     traps, as in K1;
//   * K7b and K7c share a tile and a pipeline. A block owns 64 output
//     columns and a tile of rows. It stages the tile's ids (16-byte
//     loads) and sorts each row's hot ids (0 <= id < K) once, a warp a
//     row by a bitonic network of shuffles (four rows at a time; rows
//     longer than 32 samples by rank), with K7c's cold ids compacted
//     behind them in sample order. A copy warp keeps a ring of 4 stages
//     of the hot block in flight by TMA (a 2-D tensor map over the first
//     K rows, 128-byte rows under the 128-byte swizzle, zeros past K and
//     F) on full/empty mbarriers; the consumer warpgroup multiplies stage
//     c while stages c+1.. land. The counts come from a window in shared
//     memory that the thread owning a row rewrites once per window: it
//     resets the places the window held and writes each run of equal ids
//     once, walking its sorted ids a single time (O(hits): no rescan of
//     the tile's ids, no atomics). Per-stage count building by one
//     thread group, measured first, left the tensor cores waiting on it;
//   * K7b: tiles of 64 rows x 64 columns (160 blocks at the probe's
//     shape). A = the counts, bf16 (exact up to S = 256), in wgmma's
//     canonical K-major layout, a window of 512 ids; B = the hot stage as
//     TMA wrote it, read MN-major (the transpose bit of 16-bit wgmma)
//     under the 128-byte swizzle: no transposing pass. 64 hot ids a
//     stage. What bounds it: its 1.3 GFLOP product is 1.4 us at the
//     tensor cores' peak; the hot block streams from L2 once per row
//     tile, and the sort, the count windows and the pipeline's latency
//     come on top. A hot block whose row pitch is not a multiple of 16
//     bytes (TMA's rule; F = 100 bf16 is 200 bytes) or is not 16-byte
//     aligned is staged by the copy warp's 2-byte loads into the same
//     swizzled layout (probe_hotcount_kernel<false>);
//   * K7c: one TF32 pass rounds each hot row to 10 mantissa bits (2^-11
//     relative), far above the 1e-5 the port holds it to; the rows are
//     split into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna, as
//     ops/pool.py::tf32_split) and C @ hi + C @ lo is summed (C exact in
//     TF32). TF32 wgmma reads only K-major operands from shared memory,
//     so K7c computes out^T = hot^T @ C^T: A = hot^T from registers,
//     loaded from the swizzled stage (8-byte loads without bank
//     conflicts: the tile's column 16w + 2g + j is the A row 16w + g +
//     8j of warp w, and hot row 2q + c of a k-step its k column q + 4c)
//     and split there, as K5 does; B = the counts [R rows][k], K-major
//     as written, a window of 128 ids. 32 hot ids a stage; the fragments
//     of 4 k-steps stay in registers until their wgmma is done. The
//     tensor cores truncate the accumulator at every wgmma, so at every
//     window (16 k-steps) it is added into f32 sums in shared memory and
//     restarted (K5's flush). R = tile_b in {32, 64, 80, 128} rows
//     (default 80): more rows re-read the hot block from L2 fewer times
//     (K x 64 x 4 bytes a block) and feed wgmma a wider N, but a grid
//     that leaves SMs idle or runs a second wave loses more: at the
//     probe's B 1024 and F 640, 80 rows make 130 blocks for 132 SMs,
//     64 rows two waves, 128 rows 80 blocks. What bounds it: the 2xTF32
//     product, 5.4 us at the tensor cores' peak at K = 1024; the drain
//     and rewrite of each count window, the cold half and the fixed part
//     (ids, sort) come on top;
//   * K7c's cold samples (id >= K, ~7.8 of 25 at K = 1024) are summed by
//     seven more warps straight from the table with 16-byte loads, 8 an
//     item in flight, two items at a time, in sample order, as K1 does
//     (K1's plain loads beat every bulk-copy design on zipf ids); they
//     meet the hot sums in shared memory: out = (hot + cold) / S. No id
//     compaction runs outside the kernel;
//   * sums run in a fixed order and no float atomics: results repeat bit
//     for bit. An out-of-range id traps in K7c, as in K1; K7b ignores ids
//     outside [0, K), as its plain version's counts do.
//
// Plain C interface for ctypes; each entry point returns
// cudaGetLastError() after its launch (or the error of a launch setting,
// kErrSmemMismatch or kErrTensorMap).

#include <cuda.h>   // CUtensorMap and its enums; the encoder is looked up
                    // at run time, so no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace {

using graphsage::to_float;

// a block's shared memory on the H100 (opt-in maximum)
constexpr size_t kSmemLimit = 232448;
// returned when the shared memory the wrapper sized (ops/gather_probe.py
// picks the column slice and sizes its ring) is not this file's layout
constexpr int kErrSmemMismatch = 100000;
// returned when cuTensorMapEncodeTiled is missing or refuses K7b's or
// K7c's tensor map
constexpr int kErrTensorMap = 100001;

enum Wait { kSample = 0, kRow = 1, kTile = 2 };
enum Mode { kPlain = 0, kHot = 1, kCompacted = 2 };

// K7a: the samples whose loads a consumer issues before it sums them:
// from shared memory, and in kHot from the table, whose loads wait on the
// L2 far longer (a whole row of the probe's 25 samples in one group)
constexpr int kGroup = 16;
constexpr int kHotGroup = 32;
// K7a: the items ahead whose first ids a producer thread holds
constexpr int kAhead = 4;

#ifdef GRAPHSAGE_RING_STAMPS
// K7a's timeline, in a build with GRAPHSAGE_RING_STAMPS defined
// (benchmarks/ring_timeline.py; the default build has none): clock64()
// at each step of block 0's first kStampItems items, from the first
// producer thread and each consumer group's first thread
constexpr int kStampItems = 32;
enum Stamp { kFillStart, kStageFree, kIssued, kTakeStart, kIdsReady,
             kDataReady, kSummed, kStamps };
__device__ long long ring_stamps[kStampItems][kStamps];
#define RING_STAMP(k, event, who)                                      \
  if ((who) && blockIdx.x == 0 && (k) < kStampItems)                   \
  ring_stamps[k][event] = clock64()
#else
#define RING_STAMP(k, event, who)
#endif

struct Args {
  const void* feat;         // [n_rows, F]
  const int32_t* idx;       // [B, W]: the ids, or the compacted cold ids
  const int32_t* nb;        // [B] buckets of 4 live slots (compacted)
  float* out;               // [B, F]
  int64_t n_rows;
  int B, W, S, F, FC, tile_b, n_buf, K;
  int n_tiles, n_slices;     // the launch's: items n_tiles x n_slices,
  int per_block;             // a run of per_block of them a block
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

// whether the phase of the given parity has completed, without waiting
// for it (a group of these can be in flight at once)
__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n" : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
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

__device__ __forceinline__ uint4 ld_shared_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr));
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

// ------------------------------------------------------------ the ring

// K7a's block: the producer warps, then the consumer warps
constexpr int kRingProducers = 2;
constexpr int kRingConsumers = 10;
// the consumer warps form groups that take the items in turn, so that
// two items' loads are in flight at once
constexpr int kConsumerGroups = 2;
constexpr int kGroupWarps = kRingConsumers / kConsumerGroups;
constexpr int kRingThreads = 32 * (kRingProducers + kRingConsumers);

// A stage's full mbarriers: one per slot (kSample, a copy each), per
// output row (kRow, W arrivals) or one (kTile, tile_b x W arrivals).
// Each stage also has an empty mbarrier (kGroupWarps arrivals: the
// warps of the consumer group that took the stage are done with it) and an ids mbarrier (an arrival from
// each producer thread: it has written its ids and issued its copies;
// every consumer warp waits for it before it frees the stage, so that no
// arrival on the empty mbarrier can count towards the round before).
template <int WAIT>
__host__ __device__ int full_bars(int tile_b, int W) {
  return WAIT == kSample ? tile_b * W : (WAIT == kRow ? tile_b : 1);
}

// Shared memory of the ring, in this order: n_buf stages of tile_b x W
// slots of FC elements; each stage's mbarriers (its full ones, its empty
// one, its ids one); each stage's ids [tile_b x W] and live buckets
// [tile_b]; rounded up to 16 bytes. ops/gather_probe.py::ring_bytes
// sizes it to pick the column slice and the depth and passes its size to
// the launch, which refuses one that differs.
template <int WAIT>
__host__ __device__ size_t ring_bytes(int n_buf, int tile_b, int W,
                                      size_t slice_bytes) {
  const size_t slots = static_cast<size_t>(tile_b) * W;
  const size_t bytes =
      n_buf * slots * slice_bytes
      + 8 * static_cast<size_t>(n_buf) * (full_bars<WAIT>(tile_b, W) + 2)
      + 4 * n_buf * slots + 4 * static_cast<size_t>(n_buf) * tile_b;
  return (bytes + 15) & ~static_cast<size_t>(15);
}

// ---------------------------------------------------------------- K7a

// The block walks its run of items, an item a tile of tile_b output rows
// x one column slice of FC columns, the k-th into stage k % n_buf in round
// k / n_buf. The producer warps fill stages (a thread a slot: its id, then
// one bulk copy of the slot's slice), the consumer groups sum them from
// shared memory in turn (a thread a 16-byte vector of a row's slice) and
// free them.
template <typename T, int WAIT, int MODE>
__global__ void __launch_bounds__(kRingThreads)
probe_gather_kernel(const Args a) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t slice_bytes = a.FC * sizeof(T);
  const int slots = a.tile_b * a.W;
  const int full = full_bars<WAIT>(a.tile_b, a.W);
  const int nbar = full + 2;          // then empty, then ids
  const size_t stage_bytes = static_cast<size_t>(slots) * slice_bytes;
  const uint32_t slots_addr = smem_addr(smem);
  size_t off = a.n_buf * stage_bytes;
  const uint32_t bars = slots_addr + static_cast<uint32_t>(off);
  off += 8 * static_cast<size_t>(a.n_buf) * nbar;
  int32_t* const ids = reinterpret_cast<int32_t*>(smem + off);
  off += 4 * static_cast<size_t>(a.n_buf) * slots;
  int32_t* const nbs = reinterpret_cast<int32_t*>(smem + off);
  const uint32_t full_count = WAIT == kSample ? 1u
                              : (WAIT == kRow ? static_cast<uint32_t>(a.W)
                                              : static_cast<uint32_t>(slots));
  for (int i = threadIdx.x; i < a.n_buf * nbar; i += blockDim.x) {
    const int k = i % nbar;
    mbar_init(bars + 8 * i, k < full ? full_count
                            : (k == full ? kGroupWarps
                                         : 32u * kRingProducers));
  }
  fence_barrier_init();
  __syncthreads();

  // the block's run of items, slice-major: a block keeps to one column
  // slice over consecutive tiles, as the TPU's sequential grid does
  const int i0 = blockIdx.x * a.per_block;
  const int i1 = min(a.n_tiles * a.n_slices, i0 + a.per_block);
  const int lane = threadIdx.x % 32;
  const T* feat = static_cast<const T*>(a.feat);
  if (threadIdx.x < 32 * kRingProducers) {
    // the producers: a thread a slot, slot j to lane j / P of warp j % P
    const int pt = lane * kRingProducers + threadIdx.x / 32;
    const uint64_t cold_policy = MODE == kHot ? policy_evict_first() : 0;
    // the id (and the row's live buckets) of the thread's first slot in an
    // item: loaded kAhead items before the item is filled
    auto first_of = [&](int item, int32_t& id, int32_t& nb) {
      const int64_t b =
          static_cast<int64_t>(item % a.n_tiles) * a.tile_b + pt / a.W;
      if (item < i1 && pt < slots && b < a.B) {
        id = a.idx[b * a.W + pt % a.W];
        if (MODE == kCompacted) nb = a.nb[b];
      }
    };
    // fill the k-th item's stage, its first slot's id and buckets given
    auto fill = [&](int item, int k, int32_t first, int32_t first_nb) {
      const int stage = k % a.n_buf, round = k / a.n_buf;
      const int tile = item % a.n_tiles;
      const int col0 = (item / a.n_tiles) * a.FC;
      const int64_t row0 = static_cast<int64_t>(tile) * a.tile_b;
      const uint32_t sbar = bars + 8 * stage * nbar;
      int32_t* const sids = ids + stage * slots;
      int32_t* const snbs = nbs + stage * a.tile_b;
      const uint32_t sdst =
          slots_addr + static_cast<uint32_t>(stage * stage_bytes);
      RING_STAMP(k, kFillStart, pt == 0);
      if (round > 0) mbar_wait(sbar + 8 * full, (round - 1) & 1);
      RING_STAMP(k, kStageFree, pt == 0);
      fence_proxy_async();
      for (int j = pt; j < slots; j += 32 * kRingProducers) {
        const int rr = j / a.W, s = j - rr * a.W;
        const int64_t b = row0 + rr;
        int32_t id = 0;
        bool copy = false;
        if (b < a.B) {
          id = j == pt ? first : a.idx[b * a.W + s];
          if (id < 0 || id >= a.n_rows) __trap();
          if (MODE == kHot) {
            copy = id >= a.K;
          } else if (MODE == kCompacted) {
            const int nb = j == pt ? first_nb : a.nb[b];
            if (nb < 0 || 4 * nb > a.W) __trap();
            copy = s < 4 * nb;
            if (s == 0) snbs[rr] = nb;
          } else {
            copy = true;
          }
        } else if (MODE == kCompacted && s == 0) {
          snbs[rr] = 0;
        }
        if (MODE == kHot) sids[j] = id;
        const uint32_t bar =
            sbar + 8 * (WAIT == kSample ? j : (WAIT == kRow ? rr : 0));
        if (copy) {
          mbar_arrive_expect_tx(bar, slice_bytes);
          const uint32_t dst = sdst + static_cast<uint32_t>(j) * slice_bytes;
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
      RING_STAMP(k, kIssued, pt == 0);
      mbar_arrive(sbar + 8 * (full + 1));   // this thread's slots are done
    };
    int32_t first[kAhead], first_nb[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      first[u] = first_nb[u] = 0;
      first_of(i0 + u, first[u], first_nb[u]);
    }
    // unrolled kAhead times, so that each item's prefetched values stay in
    // registers of their own until they are used
    for (int k = 0, item = i0; item < i1;) {
#pragma unroll
      for (int u = 0; u < kAhead; ++u, ++k, ++item) {
        if (item < i1) {
          fill(item, k, first[u], first_nb[u]);
          first_of(item + kAhead, first[u], first_nb[u]);
        }
      }
    }
    return;
  }

  // the consumers, in groups that take the items in turn: a thread a
  // 16-byte vector of a row's slice. No more groups than stages: a group
  // waits for an item's round of a stage only once it has taken an item
  // at least as late as the stage's round before, so that the parity it
  // waits on cannot be the round before's
  const int cw = threadIdx.x / 32 - kRingProducers;
  const int group = cw / kGroupWarps;
  const int n_groups = min(kConsumerGroups, a.n_buf);
  if (group >= n_groups) return;
  const int ct = threadIdx.x - 32 * (kRingProducers + group * kGroupWarps);
  const int vpr = a.FC / VEC;   // vectors in a row's slice
  const uint64_t hot_policy = MODE == kHot ? policy_evict_last() : 0;
  for (int k = group, item = i0 + group; item < i1;
       k += n_groups, item += n_groups) {
    const int stage = k % a.n_buf;
    const uint32_t parity = (k / a.n_buf) & 1;
    const int tile = item % a.n_tiles;
    const int col0 = (item / a.n_tiles) * a.FC;
    const int64_t row0 = static_cast<int64_t>(tile) * a.tile_b;
    const uint32_t sbar = bars + 8 * stage * nbar;
    const uint32_t sslots =
        slots_addr + static_cast<uint32_t>(stage * stage_bytes);
    RING_STAMP(k, kTakeStart, ct == 0);
    mbar_wait(sbar + 8 * (full + 1), parity);   // the stage's round began
    RING_STAMP(k, kIdsReady, ct == 0);
    if (WAIT == kTile) mbar_wait(sbar, parity);
    for (int p = ct; p < a.tile_b * vpr; p += 32 * kGroupWarps) {
      const int rr = p / vpr, v = p - rr * vpr;
      const int64_t b = row0 + rr;
      if (b >= a.B) break;   // later p are later rows
      if (WAIT == kRow) mbar_wait(sbar + 8 * rr, parity);
      float acc[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
      const int n_live =
          MODE == kCompacted ? 4 * nbs[stage * a.tile_b + rr] : a.W;
      const uint32_t row = sslots + rr * a.W * slice_bytes + 16 * v;
      const uint32_t row_bars = sbar + 8 * rr * a.W;   // kSample's
      constexpr int G = MODE == kHot ? kHotGroup : kGroup;
      // groups of G slots: the group's loads are issued before any is
      // summed; per-sample waits test the group's mbarriers together and
      // wait one by one only where a copy has not landed
      const int32_t* rid = ids + stage * slots + rr * a.W;
      for (int s0 = 0; s0 < n_live; s0 += G) {
        const int n = min(G, n_live - s0);
        uint4 raw[G];
        if (MODE == kHot) {
#pragma unroll
          for (int u = 0; u < G; ++u) {
            if (u < n && rid[s0 + u] < a.K) {
              raw[u] = ld_hint(feat + static_cast<int64_t>(rid[s0 + u]) * a.F
                                   + col0 + v * VEC, hot_policy);
            }
          }
        }
        if (WAIT == kSample) {
          bool landed = true;
#pragma unroll
          for (int u = 0; u < G; ++u) {
            if (u < n && (MODE != kHot || rid[s0 + u] >= a.K)) {
              landed &= mbar_test(row_bars + 8 * (s0 + u), parity);
            }
          }
          if (!landed) {
            for (int u = 0; u < n; ++u) {
              mbar_wait(row_bars + 8 * (s0 + u), parity);
            }
          }
        }
        RING_STAMP(k, kDataReady, ct == 0 && p == 0 && s0 == 0);
#pragma unroll
        for (int u = 0; u < G; ++u) {
          if (u < n && (MODE != kHot || rid[s0 + u] >= a.K)) {
            raw[u] = ld_shared_v4(row + (s0 + u) * slice_bytes);
          }
        }
#pragma unroll
        for (int u = 0; u < G; ++u) {
          if (u < n) add16<T>(acc, raw[u]);
        }
      }
      float* o = a.out + b * a.F + col0 + v * VEC;
#pragma unroll
      for (int e = 0; e < VEC; e += 4) {
        *reinterpret_cast<float4*>(o + e) =
            make_float4(acc[e] * a.inv_s, acc[e + 1] * a.inv_s,
                        acc[e + 2] * a.inv_s, acc[e + 3] * a.inv_s);
      }
    }
    RING_STAMP(k, kSummed, ct == 0);
    __syncwarp();
    if (lane == 0) mbar_arrive(sbar + 8 * full);   // the stage is free
  }
}

// ------------------------------------------------------- K7b/K7c: common

// the ring of hot stages in flight ahead of the products
constexpr int kHotStages = 4;
constexpr int kTileCols = 64;        // output columns a block
constexpr int kConsumers = 128;      // one warpgroup: the products
// wgmma's canonical K-major layout without swizzle (the counts): core
// matrices of 8 rows x 16 bytes, the two along K kLBO apart, the 8-row
// groups kSBO apart (as in gather_mlp_pool.cu)
constexpr uint32_t kLBO = 128;
constexpr uint32_t kSBO = 256;
// the hot stages as TMA writes them: rows of 128 bytes under the 128-byte
// swizzle (16-byte chunk c of row k at chunk c ^ (k % 8)), groups of 8
// rows kSwizzleAtom bytes apart, each box 1024-byte aligned
constexpr int kSwizzleRow = 128;
constexpr uint32_t kSwizzleAtom = 1024;
// named barriers (0 is __syncthreads): the consumers, around a count
// window's rewrite; K7c's consumers and cold warps, before the epilogue
constexpr int kBarConsumers = 1;
constexpr int kBarEpilogue = 2;

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
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

// keeps registers that an in-flight wgmma reads or writes where they are:
// the compiler sees each asm as a use, so it neither moves reads of an
// accumulator across a wgmma wait nor reuses a fragment's registers early
template <int N>
__device__ __forceinline__ void keep(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void keep(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(kLBO >> 4) << 16)
         | (static_cast<uint64_t>(kSBO >> 4) << 32);
}

// an MN-major operand under the 128-byte swizzle: the groups of 8 rows
// along K kSwizzleAtom apart (SBO); one 64-wide atom along N, so LBO is
// not read; layout type 1 (128-byte swizzle) in bits 62-63
__device__ __forceinline__ uint64_t desc_mn_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(1) << 16)
         | (static_cast<uint64_t>(kSwizzleAtom >> 4) << 32)
         | (static_cast<uint64_t>(1) << 62);
}

template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  // d[16] (+)= a (registers) * b (descriptor), m64n32k8 tf32
  static __device__ __forceinline__ void tf32(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
  }
};

template <>
struct Wgmma<64> {
  // d[32] (+)= a (registers) * b (descriptor), m64n64k8 tf32
  static __device__ __forceinline__ void tf32(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
  }
};

template <>
struct Wgmma<80> {
  // d[40] (+)= a (registers) * b (descriptor), m64n80k8 tf32
  static __device__ __forceinline__ void tf32(float (&d)[40],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
  }
};

template <>
struct Wgmma<128> {
  // d[64] (+)= a (registers) * b (descriptor), m64n128k8 tf32
  static __device__ __forceinline__ void tf32(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
};

// d[32] (+)= a * b, m64n64k16 bf16, f32 accumulate: A K-major and B
// MN-major (transposed: imm-trans-b 1), both by descriptor
__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int x,
                                            int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
         "r"(bar) : "memory");
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// the ring's mbarriers at bars: full[h] completes when hot stage h has
// landed (full_arrivals: the copy warp's expect_tx, or the lanes of a
// copy warp that stores by hand), empty[h] when the consumers are done
// with it
__device__ __forceinline__ void init_ring_bars(uint32_t bars,
                                               uint32_t full_arrivals) {
  if (threadIdx.x == 0) {
    for (int h = 0; h < kHotStages; ++h) {
      mbar_init(bars + 8 * h, full_arrivals);
      mbar_init(bars + 8 * (kHotStages + h), kConsumers);
    }
    fence_barrier_init();
  }
}

constexpr int kStageLoads = 4;   // 16-byte id loads a thread has in flight
constexpr int kSortRows = 4;     // rows a warp sorts at a time

// The tile's ids raw [rows][S] (-1 for rows past B), then each row sorted
// by a warp: its hot ids (0 <= id < K) ascending, as runs of equal ids,
// the run's id in sorted[row][j] and its length in raw[row][j], j <
// n_runs[row]; with COLD the row's cold samples (id >= K) from
// sorted[row][n_hot] on, in sample order. n_hot[row] (and n_cold[row])
// as counted. The caller synchronises.
template <bool TRAP, bool COLD>
__device__ void sort_rows(const int32_t* __restrict__ idx, int64_t row0,
                          int rows, int B, int S, int K, int64_t n_rows,
                          int32_t* raw, int32_t* sorted, int* n_runs,
                          int* n_hot, int* n_cold) {
  // the tile's rows*S ids are contiguous in idx: 16-byte loads where it
  // is aligned (rows is a multiple of 4), kStageLoads of them in flight
  const int64_t first = row0 * S;
  const int n = rows * S;
  const int live = static_cast<int>(
      min(static_cast<int64_t>(n), static_cast<int64_t>(B) * S - first));
  const bool vec = (reinterpret_cast<uintptr_t>(idx + first) & 15) == 0;
  for (int p0 = 4 * threadIdx.x; p0 < n; p0 += 4 * kStageLoads * blockDim.x) {
    int32_t v[kStageLoads][4];
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u) {
      const int p = p0 + 4 * u * blockDim.x;
      if (vec && p + 4 <= live) {
        const int4 w = __ldg(reinterpret_cast<const int4*>(idx + first + p));
        v[u][0] = w.x; v[u][1] = w.y; v[u][2] = w.z; v[u][3] = w.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[u][e] = p + e < live ? idx[first + p + e] : -1;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u) {
      const int p = p0 + 4 * u * blockDim.x;
      if (p >= n) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (TRAP && p + e < live && (v[u][e] < 0 || v[u][e] >= n_rows)) {
          __trap();
        }
      }
      *reinterpret_cast<int4*>(raw + p) =
          make_int4(v[u][0], v[u][1], v[u][2], v[u][3]);
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  if (S <= 32) {
    // a bitonic network across the warp, kSortRows rows at a time
    // (independent shuffles in flight): the hot ids ascending, the others
    // (INT32_MAX) after them; equal ids are one value, so their order does
    // not matter
    for (int r0 = kSortRows * (threadIdx.x >> 5); r0 < rows;
         r0 += kSortRows * warps) {
      int32_t v[kSortRows], key[kSortRows];
#pragma unroll
      for (int u = 0; u < kSortRows; ++u) {
        v[u] = r0 + u < rows && lane < S ? raw[(r0 + u) * S + lane] : -1;
        key[u] = v[u] >= 0 && v[u] < K ? v[u] : INT32_MAX;
      }
#pragma unroll
      for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
        for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
          for (int u = 0; u < kSortRows; ++u) {
            const int32_t other = __shfl_xor_sync(~0u, key[u], j);
            key[u] = ((lane & j) == 0) == ((lane & k) == 0)
                         ? min(key[u], other) : max(key[u], other);
          }
        }
      }
      __syncwarp();   // the rows' ids are read: raw takes the run counts
#pragma unroll
      for (int u = 0; u < kSortRows; ++u) {
        const int r = r0 + u;
        const int nh = __popc(__ballot_sync(~0u, v[u] >= 0 && v[u] < K));
        const unsigned cold = __ballot_sync(~0u, v[u] >= K);
        // runs of equal hot ids: each starts where the id changes
        const int32_t prev = __shfl_up_sync(~0u, key[u], 1);
        const bool start = lane < nh && (lane == 0 || key[u] != prev);
        const unsigned starts = __ballot_sync(~0u, start);
        if (r >= rows) continue;
        int32_t* out = sorted + r * S;
        if (start) {
          const unsigned later = starts & ~((2u << lane) - 1u);
          const int j = __popc(starts & ((1u << lane) - 1u));
          out[j] = key[u];
          raw[r * S + j] = (later ? __ffs(later) - 1 : nh) - lane;
        }
        if (COLD && v[u] >= K) {
          out[nh + __popc(cold & ((1u << lane) - 1u))] = v[u];
        }
        if (lane == 0) {
          n_runs[r] = __popc(starts);
          n_hot[r] = nh;
          if (COLD) n_cold[r] = __popc(cold);
        }
      }
    }
    return;
  }
  for (int r = threadIdx.x >> 5; r < rows; r += warps) {
    const int32_t* row = raw + r * S;
    int32_t* out = sorted + r * S;
    // longer rows: every hot sample counts the row's hot samples below it
    // (ties by position) and lands at that rank
    int nh = 0, nc = 0;
    for (int e0 = 0; e0 < S; e0 += 32) {
      const int32_t v = e0 + lane < S ? row[e0 + lane] : -1;
      nh += __popc(__ballot_sync(~0u, v >= 0 && v < K));
    }
    for (int e0 = 0; e0 < S; e0 += 32) {
      const int s = e0 + lane;
      const int32_t v = s < S ? row[s] : -1;
      int rank = 0;
      for (int j0 = 0; j0 < S; j0 += 32) {
        // lanes past S hold -1, which counts for nothing
        const int32_t mine = j0 + lane < S ? row[j0 + lane] : -1;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int32_t u = __shfl_sync(~0u, mine, j);
          rank += (u >= 0) & ((u < v) | ((u == v) & (j0 + j < s)));
        }
      }
      if (v >= 0 && v < K) out[rank] = v;
      if (COLD) {
        const unsigned cold = __ballot_sync(~0u, v >= K);
        if (v >= K) out[nh + nc + __popc(cold & ((1u << lane) - 1))] = v;
        nc += __popc(cold);
      }
    }
    __syncwarp();   // the ranks are written: the runs, by one lane
    if (lane == 0) {
      int nr = 0;
      for (int i = 0; i < nh;) {
        int j = i + 1;
        while (j < nh && out[j] == out[i]) ++j;
        out[nr] = out[i];
        raw[r * S + nr] = j - i;
        ++nr;
        i = j;
      }
      n_runs[r] = nr;
      n_hot[r] = nh;
      if (COLD) n_cold[r] = nc;
    }
  }
}

// A row's counts in a window of shared memory, written by the thread that
// owns the row: the places the window held are reset to 0, then each run
// of n equal ids in [base, base + W) is written once as n, at its offset
// in the window. The row's runs (ids[j], lengths ns[j], j < n_runs,
// ascending) are walked once over all windows (cur, and [from, to) the
// runs the window holds, at base at): O(hits), no scan of the tile's ids;
// two runs' loads in flight. T is the count's type; place(o) the byte of
// offset o.
template <int W, typename T, typename Place>
__device__ __forceinline__ void move_window(unsigned char* window,
                                            const int32_t* ids,
                                            const int32_t* ns, int n_runs,
                                            int base, int& cur, int& from,
                                            int& to, int& at, Place place) {
#pragma unroll 4
  for (int i = from; i < to; ++i) {
    *reinterpret_cast<T*>(window + place(ids[i] - at)) = T(0.f);
  }
  from = cur;
  while (cur < n_runs) {
    const int32_t id0 = ids[cur], n0 = ns[cur];
    const bool two = cur + 1 < n_runs;
    const int32_t id1 = two ? ids[cur + 1] : INT32_MAX;
    const int32_t n1 = two ? ns[cur + 1] : 0;
    if (id0 >= base + W) break;
    *reinterpret_cast<T*>(window + place(id0 - base)) =
        T(static_cast<float>(n0));
    ++cur;
    if (id1 >= base + W) break;
    *reinterpret_cast<T*>(window + place(id1 - base)) =
        T(static_cast<float>(n1));
    ++cur;
  }
  to = cur;
  at = base;
}

// ---------------------------------------------------------------- K7b

constexpr int kCountB = 128;      // B's multiple (the JAX HOT_TILE)
constexpr int kCountRows = 64;    // output rows a block: wgmma's M
constexpr int kCountKC = 64;      // hot ids a stage: 4 k-steps of 16
constexpr int kCountThreads = kConsumers + 32;   // + the copy warp
constexpr int kCountHotBytes = kCountKC * kSwizzleRow;   // [64][64] bf16
// the counts' window: 512 ids (8 stages, 32 k-steps) of the 64 rows, bf16
constexpr int kCountWindow = 512;
constexpr int kCountWindowBytes = kCountRows * kCountWindow * 2;

// K7b's shared memory, from a 1024-byte aligned base: the ring of hot
// stages, the counts' window, the full and empty mbarriers, each row's
// runs and hot ids, the ids staged and sorted [64][S] each, and 1024 bytes
// of slack for the alignment
__host__ __device__ inline size_t hotcount_bytes(int S) {
  return kHotStages * static_cast<size_t>(kCountHotBytes) + kCountWindowBytes
         + 16 * kHotStages + 8 * kCountRows
         + 8 * static_cast<size_t>(kCountRows) * S + 1024;
}

// byte of count (row, o), o < kCountWindow, in the window: k-step o / 16
// is 64 rows x 32 bytes in wgmma's canonical K-major layout
__device__ __forceinline__ int count_byte_bf16(int row, int o) {
  return (o >> 4) * (kCountRows * 32) + (row >> 3) * kSBO
         + ((o >> 3) & 1) * kLBO + (row & 7) * 16 + (o & 7) * 2;
}

struct HotcountArgs {
  const int32_t* idx;          // [B, S]
  const __nv_bfloat16* hot;    // [K, F]
  float* out;                  // [B, F]
  int B, S, F, K;
  float inv_s;
};

template <bool TMA>
__global__ void __launch_bounds__(kCountThreads, 1)
probe_hotcount_kernel(const HotcountArgs a,
                      const __grid_constant__ CUtensorMap map) {
  constexpr int kWindowChunks = kCountWindow / kCountKC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t base = smem_addr(smem);
  unsigned char* window = smem + kHotStages * kCountHotBytes;
  const int bars_off = kHotStages * kCountHotBytes + kCountWindowBytes;
  const uint32_t bars = base + bars_off;
  int* n_runs = reinterpret_cast<int*>(smem + bars_off + 16 * kHotStages);
  int* n_hot = n_runs + kCountRows;
  int32_t* raw = n_hot + kCountRows;
  int32_t* sorted = raw + kCountRows * a.S;
  const int t = threadIdx.x, lane = t & 31;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * kCountRows;
  const int col0 = blockIdx.x * kTileCols;
  const int n_chunks = (a.K + kCountKC - 1) / kCountKC;

  // full[h]: the hot stage's bytes by TMA (with the arrival that sets
  // them), or an arrival from each lane of the copy warp
  init_ring_bars(bars, TMA ? 1u : 32u);
  for (int i = t; i < kCountWindowBytes / 16; i += blockDim.x) {
    reinterpret_cast<uint4*>(window)[i] = make_uint4(0, 0, 0, 0);
  }
  sort_rows<false, false>(a.idx, row0, kCountRows, a.B, a.S, a.K, 0, raw,
                          sorted, n_runs, n_hot, nullptr);
  __syncthreads();

  if (t >= kConsumers) {
    // the copy warp: stage c of the hot block into ring slot c % 4, by
    // TMA from one lane
    if (TMA && lane != 0) return;
    for (int c = 0; c < n_chunks; ++c) {
      const int h = c % kHotStages;
      const uint32_t full = bars + 8 * h;
      if (c >= kHotStages) {
        mbar_wait(bars + 8 * (kHotStages + h), ((c / kHotStages) - 1) & 1);
      }
      if constexpr (TMA) {
        mbar_arrive_expect_tx(full, kCountHotBytes);
        tma_load_2d(base + h * kCountHotBytes, &map, col0, c * kCountKC,
                    full);
      } else {
        // a pitch TMA cannot take: 2-byte loads into the same swizzled
        // layout, zeros past K and F
        const uint16_t* hot16 = reinterpret_cast<const uint16_t*>(a.hot);
        unsigned char* stage = smem + h * kCountHotBytes;
        for (int e = lane; e < kCountKC * kTileCols; e += 32) {
          const int k = e / kTileCols, n = e % kTileCols;
          const int kk = c * kCountKC + k, col = col0 + n;
          const uint16_t v =
              kk < a.K && col < a.F
                  ? hot16[static_cast<int64_t>(kk) * a.F + col] : 0;
          *reinterpret_cast<uint16_t*>(
              stage + k * kSwizzleRow + (((n >> 3) ^ (k & 7)) << 4)
              + (n & 7) * 2) = v;
        }
        fence_proxy_async();
        mbar_arrive(full);
      }
    }
    return;
  }

  // the consumer warpgroup: 64 rows x 64 columns; thread t < 64 writes
  // row t's counts into the window (bf16, exact up to 256), 8 stages at
  // a time
  const int warp = t >> 5, g = lane >> 2, q = lane & 3;
  const int32_t* my_ids = sorted + t * a.S;
  const int32_t* my_ns = raw + t * a.S;
  const int my_runs = t < kCountRows ? n_runs[t] : 0;
  int cur = 0, from = 0, to = 0, at = 0;   // row t's walk over its ids
  const uint32_t wa = smem_addr(window);
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const int h = c % kHotStages;
    if (c % kWindowChunks == 0) {
      // every warp is done with the last window's products
      wgmma_wait<0>();
      named_sync(kBarConsumers, kConsumers);
      if (t < kCountRows) {
        move_window<kCountWindow, __nv_bfloat16>(
            window, my_ids, my_ns, my_runs, c * kCountKC, cur, from, to, at,
            [t](int o) { return count_byte_bf16(t, o); });
      }
      fence_proxy_async();   // the counts, to wgmma's reads
      named_sync(kBarConsumers, kConsumers);
    }
    mbar_wait(bars + 8 * h, (c / kHotStages) & 1);
    wgmma_fence();
    const uint32_t hb = base + h * kCountHotBytes;
    const int step0 = (c % kWindowChunks) * (kCountKC / 16);
#pragma unroll
    for (int ks = 0; ks < kCountKC / 16; ++ks) {
      wgmma_bf16_ss(acc, desc_kmajor(wa + (step0 + ks) * kCountRows * 32),
                    desc_mn_sw128(hb + ks * 16 * kSwizzleRow), 1);
    }
    wgmma_commit();
    // stage c - 1's products are done: its slot goes back to the copy warp
    wgmma_wait<1>();
    if (c >= 1) mbar_arrive(bars + 8 * (kHotStages + (c - 1) % kHotStages));
  }
  wgmma_wait<0>();
  keep(acc);

  // acc[4i + 2j + e]: row 16 warp + g + 8j, column 8i + 2q + e
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int col = col0 + 8 * i + 2 * q;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int64_t row = row0 + 16 * warp + g + 8 * j;
      if (row >= a.B) continue;
      float* o = a.out + row * a.F + col;
      const float v0 = acc[4 * i + 2 * j] * a.inv_s;
      const float v1 = acc[4 * i + 2 * j + 1] * a.inv_s;
      if ((a.F & 1) == 0 && col + 1 < a.F) {
        *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
      } else {
        if (col < a.F) o[0] = v0;
        if (col + 1 < a.F) o[1] = v1;
      }
    }
  }
}

// ---------------------------------------------------------------- K7c

constexpr int kMxKC = 32;          // hot ids a stage: 4 k-steps of 8
constexpr int kMxSteps = kMxKC / 8;
constexpr int kMxBox = 32;         // f32 columns a TMA box: one 128-byte row
constexpr int kMxHotBytes = (kTileCols / kMxBox) * kMxKC * kSwizzleRow;
// the consumer warpgroup, a copy warp (TMA) and seven cold warps: a block
// of 12 warps, 3 on each of the SM's 4 schedulers, leaves the consumers
// 168 registers (13 warps would leave 128)
constexpr int kColdThreads = 224;
constexpr int kMxThreads = kConsumers + 32 + kColdThreads;
constexpr int kColdLoads = 8;      // cold loads an item issues, then adds
// the counts' window: 128 ids (4 stages, 16 k-steps) of the R rows, f32;
// the accumulators are flushed into f32 sums at every window (K5's flush
// every 16 k-steps: the tensor cores truncate the accumulator)
constexpr int kMxWindow = 128;

// K7c's shared memory, from a 1024-byte aligned base: the ring of hot
// stages, the counts' window ([R][128] f32), the cold sums [R][64] f32,
// the flushed f32 sums (the accumulators' R / 2 values a thread, in their
// order), the mbarriers, each row's runs, hot and cold ids, the ids staged
// and sorted [R][S] each, and 1024 bytes of slack for the alignment
__host__ __device__ inline size_t hotmx_bytes(int R, int S) {
  return kHotStages * static_cast<size_t>(kMxHotBytes)
         + static_cast<size_t>(R) * kMxWindow * 4
         + 2 * static_cast<size_t>(R) * kTileCols * 4 + 16 * kHotStages
         + 12 * static_cast<size_t>(R) + 8 * static_cast<size_t>(R) * S
         + 1024;
}

// byte of count (row, o), o < kMxWindow, in a window of R rows: k-step
// o / 8 is R rows x 32 bytes, K-major; id offset o of a k-step sits at k
// column o / 2 + 4 (o % 2), where the A fragment takes hot row o
__device__ __forceinline__ int count_byte_tf32(int R, int row, int o) {
  return (o >> 3) * (R * 32) + (row >> 3) * kSBO + (o & 1) * kLBO
         + (row & 7) * 16 + ((o & 7) >> 1) * 4;
}

struct HotmxArgs {
  const float* feat;     // [n_rows, F]; the first K rows are the hot block
  const int32_t* idx;    // [B, S]
  float* out;            // [B, F]
  int64_t n_rows;
  int B, S, F, K;
  float inv_s;
};

template <int R>
__global__ void __launch_bounds__(kMxThreads, 1)
probe_hotmx_kernel(const HotmxArgs a,
                   const __grid_constant__ CUtensorMap map) {
  constexpr int kWindowChunks = kMxWindow / kMxKC;
  constexpr int kWindowBytes = R * kMxWindow * 4;
  constexpr int kItems = R * (kTileCols / 4);   // (row, 16-byte vector)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t base = smem_addr(smem);
  unsigned char* window = smem + kHotStages * kMxHotBytes;
  float* cold = reinterpret_cast<float*>(window + kWindowBytes);
  float* sums = cold + R * kTileCols;
  unsigned char* bars_ptr = reinterpret_cast<unsigned char*>(
      sums + R * kTileCols);
  const uint32_t bars = smem_addr(bars_ptr);
  int* n_runs = reinterpret_cast<int*>(bars_ptr + 16 * kHotStages);
  int* n_hot = n_runs + R;
  int* n_cold = n_hot + R;
  int32_t* raw = n_cold + R;
  int32_t* sorted = raw + R * a.S;
  const int t = threadIdx.x, lane = t & 31;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * R;
  const int col0 = blockIdx.x * kTileCols;
  const int n_chunks = (a.K + kMxKC - 1) / kMxKC;

  init_ring_bars(bars, 1);   // the TMA's arrival, with its bytes
  for (int i = t; i < kWindowBytes / 16; i += blockDim.x) {
    reinterpret_cast<uint4*>(window)[i] = make_uint4(0, 0, 0, 0);
  }
  sort_rows<true, true>(a.idx, row0, R, a.B, a.S, a.K, a.n_rows, raw, sorted,
                        n_runs, n_hot, n_cold);
  __syncthreads();

  if (t >= kConsumers + 32) {
    // the cold warps: (row, 16-byte vector) items two at a time, each the
    // sum of its row's cold samples in sample order, kColdLoads loads an
    // item in flight
    for (int i0 = t - kConsumers - 32; i0 < kItems; i0 += 2 * kColdThreads) {
      int n[2], col[2];
      const int32_t* ids[2];
      float4 sum[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int item = i0 + u * kColdThreads;
        const int r = item / (kTileCols / 4);
        col[u] = col0 + 4 * (item % (kTileCols / 4));
        const bool live = item < kItems && col[u] < a.F;
        n[u] = live ? n_cold[r] : 0;
        ids[u] = sorted + (live ? r * a.S + n_hot[r] : 0);
        sum[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      for (int s0 = 0; s0 < max(n[0], n[1]); s0 += kColdLoads) {
        float4 x[2][kColdLoads];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
#pragma unroll
          for (int l = 0; l < kColdLoads; ++l) {
            if (s0 + l < n[u]) {
              x[u][l] = __ldg(reinterpret_cast<const float4*>(
                  a.feat + static_cast<int64_t>(ids[u][s0 + l]) * a.F
                  + col[u]));
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
#pragma unroll
          for (int l = 0; l < kColdLoads; ++l) {
            if (s0 + l < n[u]) {
              sum[u].x += x[u][l].x;
              sum[u].y += x[u][l].y;
              sum[u].z += x[u][l].z;
              sum[u].w += x[u][l].w;
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int item = i0 + u * kColdThreads;
        if (item < kItems) {
          *reinterpret_cast<float4*>(cold + item * 4) = sum[u];
        }
      }
    }
    named_arrive(kBarEpilogue, kConsumers + kColdThreads);
    return;
  }
  if (t >= kConsumers) {
    // the copy warp: stage c of the hot rows (two boxes of 32 columns)
    // into ring slot c % 4, by TMA from one lane
    if (lane != 0) return;
    for (int c = 0; c < n_chunks; ++c) {
      const int h = c % kHotStages;
      const uint32_t full = bars + 8 * h;
      if (c >= kHotStages) {
        mbar_wait(bars + 8 * (kHotStages + h), ((c / kHotStages) - 1) & 1);
      }
      mbar_arrive_expect_tx(full, kMxHotBytes);
#pragma unroll
      for (int box = 0; box < kTileCols / kMxBox; ++box) {
        tma_load_2d(base + h * kMxHotBytes + box * kMxKC * kSwizzleRow, &map,
                    col0 + box * kMxBox, c * kMxKC, full);
      }
    }
    return;
  }

  // the consumer warpgroup: out^T [64 columns x R rows], 4 k-steps a
  // stage. Thread t < R writes row t's counts into the window (f32, exact
  // in TF32), K-major: k-step ks of 8 ids is R rows x 32 bytes; id offset
  // o sits at k column o / 2 + 4 (o % 2), where the A fragment takes hot
  // row o: the even ids' counts in the row's first core-matrix row, the
  // odd ones' kLBO on
  const int warp = t >> 5, g = lane >> 2, q = lane & 3;
  const int32_t* my_ids = sorted + t * a.S;
  const int32_t* my_ns = raw + t * a.S;
  const int my_runs = t < R ? n_runs[t] : 0;
  int cur = 0, from = 0, to = 0, at = 0;   // row t's walk over its ids
  const uint32_t wa = smem_addr(window);
  // this thread's A elements in a stage: columns 16 warp + 2g and + 1
  // (box warp / 2, 16-byte chunk 4 (warp % 2) + g / 2, half g % 2) of hot
  // rows 8 ks + 2q + c
  const int box_off = (warp >> 1) * kMxKC * kSwizzleRow;
  const int chunk = 4 * (warp & 1) + (g >> 1);
  const int half = (g & 1) * 8;
  float acc[R / 2];
#pragma unroll
  for (int i = 0; i < R / 2; ++i) acc[i] = 0.f;
  uint32_t hi[kMxSteps][4], lo[kMxSteps][4];
#pragma unroll
  for (int ks = 0; ks < kMxSteps; ++ks) {
#pragma unroll
    for (int e = 0; e < 4; ++e) hi[ks][e] = lo[ks][e] = 0u;
  }
  // hot rows 8 ks + 2q and + 1 of a stage, columns 16 warp + 2g, + 1
  float2 v[2];
  auto load_hot = [&](const unsigned char* stage, int ks) {
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int k = 8 * ks + 2 * q + cc;
      v[cc] = *reinterpret_cast<const float2*>(
          stage + k * kSwizzleRow + ((chunk ^ (k & 7)) << 4) + half);
    }
  };
  if (n_chunks > 0) {
    mbar_wait(bars, 0);
    load_hot(smem + box_off, 0);
  }
  bool flushed = false;
  int scale = 0;
  for (int c = 0; c < n_chunks; ++c) {
    const int h = c % kHotStages;
    if (c % kWindowChunks == 0) {
      if (c > 0) {
        // the window's products into the f32 sums in shared memory (value
        // i of thread t at [i][t]); the next product restarts acc
        wgmma_wait<0>();
        keep(acc);
#pragma unroll
        for (int i = 0; i < R / 2; ++i) {
          sums[i * kConsumers + t] =
              (flushed ? sums[i * kConsumers + t] : 0.f) + acc[i];
        }
        flushed = true;
        scale = 0;
      }
      named_sync(kBarConsumers, kConsumers);   // the window is free
      if (t < R) {
        move_window<kMxWindow, float>(
            window, my_ids, my_ns, my_runs, c * kMxKC, cur, from, to, at,
            [t](int o) { return count_byte_tf32(R, t, o); });
      }
      fence_proxy_async();   // the counts, to wgmma's reads
      named_sync(kBarConsumers, kConsumers);
    }
    const unsigned char* hs = smem + h * kMxHotBytes + box_off;
    const int step0 = (c % kWindowChunks) * kMxSteps;
#pragma unroll
    for (int ks = 0; ks < kMxSteps; ++ks) {
      // the k-step's A fragment, split: a[2c + j] is column 16 warp +
      // 2g + j of hot row 8 ks + 2q + c (loaded a k-step ahead)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const float h0 = tf32_rna(v[cc].x), h1 = tf32_rna(v[cc].y);
        hi[ks][2 * cc] = __float_as_uint(h0);
        hi[ks][2 * cc + 1] = __float_as_uint(h1);
        lo[ks][2 * cc] = __float_as_uint(tf32_rna(v[cc].x - h0));
        lo[ks][2 * cc + 1] = __float_as_uint(tf32_rna(v[cc].y - h1));
      }
      if (ks + 1 < kMxSteps) load_hot(hs, ks + 1);
      wgmma_fence();
      const uint64_t db = desc_kmajor(wa + (step0 + ks) * R * 32);
      Wgmma<R>::tf32(acc, hi[ks], db, scale);
      Wgmma<R>::tf32(acc, lo[ks], db, 1);
      wgmma_commit();
      scale = 1;
      if (ks + 1 == kMxSteps) {
        // every value of the stage is in registers: the slot goes back to
        // the copy warp; the next stage's first values come while these
        // products run
        mbar_arrive(bars + 8 * (kHotStages + h));
        if (c + 1 < n_chunks) {
          const int h1 = (c + 1) % kHotStages;
          mbar_wait(bars + 8 * h1, ((c + 1) / kHotStages) & 1);
          load_hot(smem + h1 * kMxHotBytes + box_off, 0);
        }
      }
      // the k-step whose fragment slot comes next is done
      wgmma_wait<kMxSteps - 1>();
#pragma unroll
      for (int j = 0; j < kMxSteps; ++j) {
        keep(hi[j]);
        keep(lo[j]);
      }
    }
  }
  wgmma_wait<0>();
  keep(acc);
  named_sync(kBarEpilogue, kConsumers + kColdThreads);   // the cold sums

  // value i, sums + acc: tile column 16 warp + 2g + j, tile row 8 (i / 4)
  // + 2q + e for i % 4 = 2j + e
  const int col = 16 * warp + 2 * g;
  if (col0 + col >= a.F) return;
#pragma unroll
  for (int i = 0; i < R / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = 8 * i + 2 * q + e;
      const int64_t row = row0 + r;
      if (row >= a.B) continue;
      float hot[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int x = 4 * i + 2 * j + e;
        hot[j] = (flushed ? sums[x * kConsumers + t] : 0.f) + acc[x];
      }
      const float2 cv =
          *reinterpret_cast<const float2*>(cold + r * kTileCols + col);
      *reinterpret_cast<float2*>(a.out + row * a.F + col0 + col) =
          make_float2((hot[0] + cv.x) * a.inv_s, (hot[1] + cv.y) * a.inv_s);
    }
  }
}

// ------------------------------------------------------------- launches

// a persistent grid: as many blocks as the SMs hold at the ring's
// shared memory, each walking a run of items (tile x slice), the runs
// within one item of each other
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
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel,
                                                      kRingThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (occ < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  a.n_slices = a.F / a.FC;
  a.n_tiles = (a.B + a.tile_b - 1) / a.tile_b;
  const long long items = static_cast<long long>(a.n_tiles) * a.n_slices;
  if (items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const long long fill = static_cast<long long>(n_sm) * occ;
  a.per_block = static_cast<int>((items + fill - 1) / fill);
  const long long grid = (items + a.per_block - 1) / a.per_block;
  kernel<<<static_cast<unsigned int>(grid), kRingThreads, smem,
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

// ------------------------------------------------- K7b/K7c: tensor maps

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (nullptr where it
// is missing)
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// the map of a row-major [rows, cols] tensor in boxes of box_rows x
// box_cols (box_cols x elem = 128 bytes), 128-byte swizzle, zeros outside
bool swizzled_map(CUtensorMap* map, CUtensorMapDataType type,
                  const void* ptr, int rows, int cols, int elem,
                  int box_rows, int box_cols) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename Kernel, typename KernelArgs>
int launch_tiles(Kernel kernel, const KernelArgs& a, const CUtensorMap& map,
                 dim3 grid, int threads, size_t smem, void* stream) {
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(a, map);
  return static_cast<int>(cudaGetLastError());
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

// K7b. idx [B, S] with B a multiple of 128, hot [K, F] bf16, out [B, F];
// smem is hotcount_bytes(S). TMA stages the hot block where its row pitch
// is a multiple of 16 bytes and it is 16-byte aligned; the producer
// warp's loads stage it otherwise.
int graphsage_probe_hotcount(const void* idx, const void* hot, void* out,
                             int B, int S, int F, int K, long long smem,
                             void* stream) {
  if (B <= 0 || B % kCountB != 0 || S <= 0 || F <= 0 || K < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (static_cast<size_t>(smem) != hotcount_bytes(S)) return kErrSmemMismatch;
  const HotcountArgs a{static_cast<const int32_t*>(idx),
                       static_cast<const __nv_bfloat16*>(hot),
                       static_cast<float*>(out), B, S, F, K,
                       1.f / static_cast<float>(S)};
  const bool tma = K > 0 && F % 8 == 0
                   && reinterpret_cast<uintptr_t>(hot) % 16 == 0;
  CUtensorMap map{};
  if (tma && !swizzled_map(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, hot, K,
                           F, 2, kCountKC, kTileCols)) {
    return kErrTensorMap;
  }
  const dim3 grid((F + kTileCols - 1) / kTileCols, B / kCountRows);
  return tma ? launch_tiles(probe_hotcount_kernel<true>, a, map, grid,
                            kCountThreads, static_cast<size_t>(smem), stream)
             : launch_tiles(probe_hotcount_kernel<false>, a, map, grid,
                            kCountThreads, static_cast<size_t>(smem), stream);
}

// K7c. feat [n_rows, F] f32, 16-byte aligned, F a multiple of 4 (its
// first K rows are the hot block), idx [B, S] in [0, n_rows), out [B, F];
// tile_b 32, 64, 80 or 128 rows a block; smem is hotmx_bytes(tile_b, S)
int graphsage_probe_hotmx(const void* feat, const void* idx, void* out,
                          long long n_rows, int B, int S, int F, int K,
                          int tile_b, long long smem, void* stream) {
  if (B <= 0 || S <= 0 || F <= 0 || F % 4 != 0 || K < 0 || K > n_rows
      || reinterpret_cast<uintptr_t>(feat) % 16 != 0
      || (tile_b != 32 && tile_b != 64 && tile_b != 80 && tile_b != 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (static_cast<size_t>(smem) != hotmx_bytes(tile_b, S)) {
    return kErrSmemMismatch;
  }
  const HotmxArgs a{static_cast<const float*>(feat),
                    static_cast<const int32_t*>(idx),
                    static_cast<float*>(out), n_rows, B, S, F, K,
                    1.f / static_cast<float>(S)};
  CUtensorMap map{};
  if (K > 0 && !swizzled_map(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, feat, K,
                             F, 4, kMxKC, kMxBox)) {
    return kErrTensorMap;
  }
  const dim3 grid((F + kTileCols - 1) / kTileCols, (B + tile_b - 1) / tile_b);
  const size_t bytes = static_cast<size_t>(smem);
  switch (tile_b) {
    case 32:
      return launch_tiles(probe_hotmx_kernel<32>, a, map, grid, kMxThreads,
                          bytes, stream);
    case 64:
      return launch_tiles(probe_hotmx_kernel<64>, a, map, grid, kMxThreads,
                          bytes, stream);
    case 80:
      return launch_tiles(probe_hotmx_kernel<80>, a, map, grid, kMxThreads,
                          bytes, stream);
    default:
      return launch_tiles(probe_hotmx_kernel<128>, a, map, grid, kMxThreads,
                          bytes, stream);
  }
}

#ifdef GRAPHSAGE_RING_STAMPS
// K7a's stamps [kStampItems][kStamps] into host, then zeroed
int graphsage_probe_ring_stamps(long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, ring_stamps,
                                         sizeof(ring_stamps));
  if (err != cudaSuccess) return static_cast<int>(err);
  void* dev = nullptr;
  err = cudaGetSymbolAddress(&dev, ring_stamps);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaMemset(dev, 0, sizeof(ring_stamps)));
}
#endif

const char* graphsage_cuda_error_string(int err) {
  if (err == kErrSmemMismatch) {
    return "the shared memory the wrapper sized (ops/gather_probe.py) is "
           "not the kernel's layout";
  }
  if (err == kErrTensorMap) {
    return "cuTensorMapEncodeTiled could not encode the hot block's tensor "
           "map";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
