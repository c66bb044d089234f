// Fused Line-7 server merge for Hopper (sm_90a).
//
// Replaces the Pallas kernel merge_stacked of
// src/repro/kernels/sync_compress/kernel.py (def :405, pallas_call :435):
// out[m, :] = sum_i w_i z[i, :] for every row m (w normalised by its sum
// in-register when asked, unit weights when absent); rows with recv[m] = 0
// keep old[m, :] instead.
//
// Bound on an H100: HBM bandwidth. Per element of the (M, n) fleet payload
// it must read z once and write out once, 8 B (plus 4 B of old for each
// row that does not receive). At 3.35 TB/s that is 2.5 us for M=64,
// n=16384. The M multiply-adds per column are far below the f32 rate.
//
// Design: each thread owns a column (four adjacent columns, as float4, when
// the row length and pointers allow it), accumulates the weighted sum over
// the M rows in a fixed order in f32 registers, then writes the sum down
// the same column of every row. So z is read once, out written once, and
// the sum is deterministic with no atomics. The weights (normalised once
// per block when asked) sit in shared memory. The grid is 1-D over column
// groups; the ragged tail is masked by the column bound.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <int V>
__global__ void __launch_bounds__(kThreads)
merge_kernel(const float* __restrict__ z, const float* __restrict__ w,
             const float* __restrict__ recv, const float* __restrict__ old,
             float* __restrict__ out, int rows, int n, int normalize) {
  extern __shared__ float wsh[];  // rows weights
  __shared__ float total;
  if (w != nullptr) {
    for (int i = threadIdx.x; i < rows; i += kThreads) wsh[i] = w[i];
    __syncthreads();
    if (normalize) {
      if (threadIdx.x == 0) {
        float s = 0.f;
        for (int i = 0; i < rows; ++i) s += wsh[i];
        total = s;
      }
      __syncthreads();
      for (int i = threadIdx.x; i < rows; i += kThreads) wsh[i] /= total;
      __syncthreads();
    }
  }
  const int64_t col = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * V;
  if (col >= n) return;

  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
  for (int i = 0; i < rows; ++i) {
    const float* zi = z + static_cast<int64_t>(i) * n + col;
    float zv[V];
    if constexpr (V == 4) {
      const float4 t = *reinterpret_cast<const float4*>(zi);
      zv[0] = t.x; zv[1] = t.y; zv[2] = t.z; zv[3] = t.w;
    } else {
      zv[0] = zi[0];
    }
    const float wi = (w != nullptr) ? wsh[i] : 1.f;
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = (w != nullptr) ? acc[v] + wi * zv[v] : acc[v] + zv[v];
  }
  for (int i = 0; i < rows; ++i) {
    const int64_t off = static_cast<int64_t>(i) * n + col;
    float ov[V];
    const bool keep_old = recv != nullptr && !(recv[i] > 0.f);
#pragma unroll
    for (int v = 0; v < V; ++v) ov[v] = keep_old ? old[off + v] : acc[v];
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(out + off) = make_float4(ov[0], ov[1], ov[2], ov[3]);
    } else {
      out[off] = ov[0];
    }
  }
}

}  // namespace

extern "C" {

// w, recv and old may be null (unit weights / every row receives).
int merge_stacked_launch(const float* z, const float* w, const float* recv,
                         const float* old, float* out, int rows, int n,
                         int normalize, int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(rows) * sizeof(float);
  if (vec) {
    const int groups = n / 4;
    const unsigned blocks = static_cast<unsigned>((groups + kThreads - 1) / kThreads);
    merge_kernel<4><<<blocks, kThreads, smem, s>>>(z, w, recv, old, out, rows, n, normalize);
  } else {
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    merge_kernel<1><<<blocks, kThreads, smem, s>>>(z, w, recv, old, out, rows, n, normalize);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
