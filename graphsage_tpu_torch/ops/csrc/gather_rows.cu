// Row gather for Hopper (sm_90a):
//
//   K4: out[r, :] = feat[idx[r], :]   feat [N, F], idx [B*S], out [B*S, F]
//
// in the table's dtype, bit for bit index_select's result. K4 replaces
// graphsage_tpu/ops/gather.py::_gather_rows_kernel (fused_gather_rows),
// which issues one HBM->HBM DMA per sampled row for the consumers that
// need the individual rows of the innermost hop (the pooling MLPs, the
// LSTM sequence).
//
// What bounds it on the H100: memory bytes; it does no arithmetic. Each
// distinct gathered row is read once (repeats of a zipf hub row come
// from L2), the [B*S, F] output is written once, plus the idx: at the
// serving hop (128,000 rows of F = 602 from the sampler, ~13.4k
// distinct) that is 32 MB + 308.2 MB + 0.5 MB, 0.102 ms at 3.35 TB/s
// for an f32 table and half of that for bf16.
//
// Design (a simple, correct first version): a copy of bytes, so one
// kernel serves every dtype and every F. One warp copies one row in
// units of U bytes, the widest of 16, 8, 4 or 2 that divides the row's
// bytes and both row starts (the wrapper picks it; F = 602 f32 rows are
// 2,408 bytes, copied in 8-byte units), neighbouring lanes on
// neighbouring addresses. Each lane loads up to four units before it
// stores them, so that a warp keeps several loads in flight. The
// output is written with streaming stores (st.global.cs), which mark
// its lines evict-first: the 308 MB of output then does not push the
// hub rows, which later samples read again, out of the 50 MB L2. Row
// offsets are 64-bit and one launch covers all rows; an out-of-range
// index traps, as PyTorch's own index kernels do.
// Left to a later PR: TMA bulk copies of whole rows (cp.async.bulk),
// which would take the copy off the load/store units.
//
// Plain C interface for ctypes; the entry point returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 4;

template <typename U>
__global__ void gather_rows_kernel(const U* __restrict__ feat,
                                   const int32_t* __restrict__ idx,
                                   U* __restrict__ out, int64_t n_rows,
                                   int64_t n_out, int64_t units_per_row) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                    threadIdx.x / 32;
  if (r >= n_out) return;
  const int lane = threadIdx.x % 32;
  const int64_t src_row = idx[r];
  if (src_row < 0 || src_row >= n_rows) __trap();
  const U* src = feat + src_row * units_per_row;
  U* dst = out + r * units_per_row;
  for (int64_t k0 = lane; k0 < units_per_row; k0 += kUnroll * 32) {
    U v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int64_t k = k0 + j * 32;
      if (k < units_per_row) v[j] = __ldg(src + k);
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int64_t k = k0 + j * 32;
      if (k < units_per_row) __stcs(dst + k, v[j]);
    }
  }
}

template <typename U>
int launch(const void* feat, const void* idx, void* out, long long n_rows,
           long long n_out, long long row_bytes, void* stream) {
  const long long blocks = (n_out + kWarpsPerBlock - 1) / kWarpsPerBlock;
  gather_rows_kernel<U><<<static_cast<unsigned int>(blocks),
                          kWarpsPerBlock * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const U*>(feat), static_cast<const int32_t*>(idx),
      static_cast<U*>(out), n_rows, n_out,
      row_bytes / static_cast<long long>(sizeof(U)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// n_out = B*S rows; unit: bytes per access, 16, 8, 4 or 2, dividing
// row_bytes and both base addresses.
int graphsage_gather_rows(const void* feat, const void* idx, void* out,
                          long long n_rows, long long n_out,
                          long long row_bytes, int unit, void* stream) {
  if ((n_out + kWarpsPerBlock - 1) / kWarpsPerBlock > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (unit) {
    case 16:
      return launch<uint4>(feat, idx, out, n_rows, n_out, row_bytes, stream);
    case 8:
      return launch<uint2>(feat, idx, out, n_rows, n_out, row_bytes, stream);
    case 4:
      return launch<unsigned int>(feat, idx, out, n_rows, n_out, row_bytes,
                                  stream);
    case 2:
      return launch<unsigned short>(feat, idx, out, n_rows, n_out, row_bytes,
                                    stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* graphsage_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
