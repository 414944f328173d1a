// Strided-to-row-major copy of f32 rows of 16 for Hopper (sm_90a).
//
// Replaces: tools/exp_r5_reduce.py::_id_kernel (launched by force_rowmajor),
// the TPU kernel that copies the (M, 16) per-duplicate gradient rows through
// VMEM in (1024, 16) blocks so that XLA sees them in a row-major layout. On
// the card the layout is explicit, so the same function is a copy of a
// strided view (B, R, 16) with element strides (s0, s1, s2) into a
// contiguous (B * R, 16) tensor: dst[b * R + r][c] = src[b*s0 + r*s1 + c*s2].
// The tool passes the channel-major (MB, 16, KB) gradient transposed to
// (MB, KB, 16), so s1 = 1 and s2 = KB.
//
// Design: one thread per 16-byte chunk (a quarter row) of the output, four
// scalar loads and one float4 store. Four consecutive threads fill one
// output row, so a warp stores 512 contiguous bytes; with s1 = 1, the
// threads of a warp that load the same channel read 8 consecutive floats,
// which keeps every 32-byte sector of the source fully used.
//
// What bounds it on the H100: bytes. It reads each of the M x 16 source
// floats once and writes each output float once, 2 x 64 B per row (50 MB
// at M = 393,216, 0.015 ms at 3.35 TB/s); it does no arithmetic.

#include <cuda_runtime.h>

namespace {

constexpr int kRec = 16;
constexpr int kChunks = kRec / 4;   // float4 chunks per row
constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
row_copy_kernel(const float* __restrict__ src, long long s0, long long s1,
                long long s2, long long rows_per_batch, long long n_chunks,
                float4* __restrict__ dst) {
  const long long i = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= n_chunks) return;
  const long long row = i / kChunks;
  const long long c0 = (i % kChunks) * 4;
  const long long b = row / rows_per_batch;
  const long long r = row - b * rows_per_batch;
  const float* p = src + b * s0 + r * s1 + c0 * s2;
  float4 v;
  v.x = __ldg(p);
  v.y = __ldg(p + s2);
  v.z = __ldg(p + 2 * s2);
  v.w = __ldg(p + 3 * s2);
  dst[i] = v;
}

}  // namespace

// Copies the (batches, rows_per_batch, 16) view at `src` with element strides
// (s0, s1, s2) into the contiguous (batches * rows_per_batch, 16) `dst`.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int d3gs_row_copy(const float* src, long long s0, long long s1,
                             long long s2, long long batches,
                             long long rows_per_batch, float* dst,
                             void* stream) {
  const long long n_chunks = batches * rows_per_batch * kChunks;
  if (n_chunks > 0) {
    const long long blocks = (n_chunks + kBlock - 1) / kBlock;
    row_copy_kernel<<<static_cast<unsigned>(blocks), kBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        src, s0, s1, s2, rows_per_batch, n_chunks,
        reinterpret_cast<float4*>(dst));
  }
  return static_cast<int>(cudaGetLastError());
}
