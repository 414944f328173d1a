// Row gather from an (N, 16) f32 table for Hopper (sm_90a):
// out[r, :] = table[idx[r], :].
//
// Replaces: tools/exp_vmem_gather.py::kernel_take and ::kernel_loop (both
// launched by build), the TPU probe that keeps the 2.8 MB table resident in
// VMEM and gathers one row per index lane, with jnp.take or with a loop of
// dynamic row slices. The two are one function here.
//
// Design: one thread per quarter row, one 16-byte float4 load from the table
// and one float4 store, so four consecutive threads move one 64-byte row and
// a warp writes 512 contiguous bytes. The table is not staged in shared
// memory: at 44,032 x 64 B = 2.8 MB it is twelve times a block's 227 KB, and
// it sits in the H100's 50 MB L2 after the first touches, which is where the
// random row reads are served from. The index is read once per thread
// (four threads share it through L1).
//
// What bounds it on the H100: bytes. Each output row costs a 4-byte index,
// a 64-byte table row (from L2 once warm) and a 64-byte store; counting each
// input once (the table, the indices) and each output once, 65,536 rows move
// 7.3 MB (0.0022 ms at 3.35 TB/s). There is no arithmetic.

#include <cuda_runtime.h>

namespace {

constexpr int kChunks = 4;   // float4 chunks per 16-float row
constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
row_gather_kernel(const float4* __restrict__ table,
                  const int* __restrict__ idx, long long n_chunks,
                  float4* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= n_chunks) return;
  const long long row = __ldg(idx + i / kChunks);
  out[i] = __ldg(table + row * kChunks + (i % kChunks));
}

}  // namespace

// Gathers n_rows rows of the contiguous (N, 16) `table` at the int32 `idx`
// (each in [0, N), checked by the caller) into the contiguous (n_rows, 16)
// `out`. Launches on `stream` and returns cudaGetLastError().
extern "C" int d3gs_row_gather(const float* table, const int* idx,
                               long long n_rows, float* out, void* stream) {
  const long long n_chunks = n_rows * kChunks;
  if (n_chunks > 0) {
    const long long blocks = (n_chunks + kBlock - 1) / kBlock;
    row_gather_kernel<<<static_cast<unsigned>(blocks), kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(table), idx, n_chunks,
        reinterpret_cast<float4*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
