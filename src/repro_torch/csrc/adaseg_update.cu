// Fused LocalAdaSEG extragradient kernels for Hopper (sm_90a).
//
// Replace the Pallas kernels of src/repro/kernels/adaseg_update/kernel.py:
//   adaseg_explore_launch  <- adaseg_explore (kernel.py:176, pallas_call :192)
//   adaseg_anchor_launch   <- adaseg_anchor  (kernel.py:206, pallas_call :221)
//   adaseg_finish_launch   <- adaseg_finish  (kernel.py:236, pallas_call :248)
//
// Bound on an H100: each kernel is an elementwise pass with per-worker sums,
// so it is bound by HBM bandwidth. Per element of the worker-stacked (M, n)
// leaf it must move: explore 12 B (read z*, m; write z_t), anchor 16 B
// (read z*, z_t, g; write z~), finish 20 B (read z*, raw_t, raw_l; write
// z_t, z~). At 3.35 TB/s that is 3.8 us, 5.0 us and 6.3 us for M=64,
// n=16384. The arithmetic (a few flops per element) is far below the f32
// rate.
//
// Design: one launch covers the whole fleet. The grid is (column tiles x
// workers); a block owns one tile of one worker's row, so eta (computed
// in-register as d_alpha / sqrtf(g0^2 + sum_sq[m]) when fused), the box
// clip and the per-worker statistics never leave registers, and every byte
// is read or written exactly once. Loads and stores are float4 when the
// row length and the pointers allow it; the ragged tail is masked by the
// loop bound, so elements past n never enter the statistics (a box with
// lo > 0 cannot leak clip(0) into them). Statistics are reduced with warp
// shuffles, then across the block's warps in a fixed order, into
// (M, tiles, k) partials with no atomics: the caller sums the tiles in a
// fixed order, so reruns are bit-identical.
//
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Step {        // eta for row m: given, or fused from sum_sq
  const float* sched;
  int fuse;
  float g0_sq;
  float d_alpha;
  __device__ __forceinline__ float eta(int m) const {
    const float s = sched[m];
    return fuse ? d_alpha / sqrtf(g0_sq + s) : s;
  }
};

struct Box {         // optional clip onto [lo, hi]
  int on;
  float lo;
  float hi;
  __device__ __forceinline__ float operator()(float v) const {
    return on ? fminf(fmaxf(v, lo), hi) : v;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// Sums each acc[k] over the block; thread 0 writes the K results to out.
template <int K>
__device__ __forceinline__ void block_sum_store(float (&acc)[K], float* out) {
  __shared__ float smem[K][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float v = warp_sum(acc[k]);
    if (lane == 0) smem[k][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += smem[k][w];
      out[k] = s;
    }
  }
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// The block's slice of its row: columns [start, end) of row blockIdx.y.
struct Tile {
  int64_t base;  // row offset
  int start;
  int end;
  __device__ Tile(int n, int tile) {
    base = static_cast<int64_t>(blockIdx.y) * n;
    start = blockIdx.x * tile;
    end = min(start + tile, n);
  }
  __device__ __forceinline__ float* partial(float* part, int k) const {
    return part + (static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x) * k;
  }
};

// ---------------------------------------------------------------------------
// B1 explore: out = clip(z - eta*m); partials [sum out^2 (want_norm), sum m^2]
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
explore_kernel(const float* __restrict__ z, const float* __restrict__ m,
               float* __restrict__ out, float* __restrict__ part, int n,
               int tile, int vec, Step step, Box box, int want_norm) {
  const Tile t(n, tile);
  const float eta = step.eta(blockIdx.y);
  float acc[2] = {0.f, 0.f};
  auto elem = [&](float zv, float mv) {
    const float o = box(zv - eta * mv);
    if (want_norm) acc[0] += o * o;
    acc[1] += mv * mv;
    return o;
  };
  if (vec) {
    for (int j = t.start + 4 * threadIdx.x; j < t.end; j += 4 * kThreads) {
      float zv[4], mv[4], ov[4];
      load4(z + t.base + j, zv);
      load4(m + t.base + j, mv);
#pragma unroll
      for (int i = 0; i < 4; ++i) ov[i] = elem(zv[i], mv[i]);
      store4(out + t.base + j, ov);
    }
  } else {
    for (int j = t.start + threadIdx.x; j < t.end; j += kThreads) {
      out[t.base + j] = elem(z[t.base + j], m[t.base + j]);
    }
  }
  block_sum_store<2>(acc, t.partial(part, 2));
}

// ---------------------------------------------------------------------------
// B2 anchor: ztl = clip(z - eta*g); partials [sum (zt-z)^2 + (zt-ztl)^2,
// sum g^2]
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
anchor_kernel(const float* __restrict__ z, const float* __restrict__ zt,
              const float* __restrict__ g, float* __restrict__ ztl,
              float* __restrict__ part, int n, int tile, int vec, Step step,
              Box box) {
  const Tile t(n, tile);
  const float eta = step.eta(blockIdx.y);
  float acc[2] = {0.f, 0.f};
  auto elem = [&](float zv, float tv, float gv) {
    const float l = box(zv - eta * gv);
    const float d1 = tv - zv;
    const float d2 = tv - l;
    acc[0] += d1 * d1 + d2 * d2;
    acc[1] += gv * gv;
    return l;
  };
  if (vec) {
    for (int j = t.start + 4 * threadIdx.x; j < t.end; j += 4 * kThreads) {
      float zv[4], tv[4], gv[4], lv[4];
      load4(z + t.base + j, zv);
      load4(zt + t.base + j, tv);
      load4(g + t.base + j, gv);
#pragma unroll
      for (int i = 0; i < 4; ++i) lv[i] = elem(zv[i], tv[i], gv[i]);
      store4(ztl + t.base + j, lv);
    }
  } else {
    for (int j = t.start + threadIdx.x; j < t.end; j += kThreads) {
      ztl[t.base + j] = elem(z[t.base + j], zt[t.base + j], g[t.base + j]);
    }
  }
  block_sum_store<2>(acc, t.partial(part, 2));
}

// ---------------------------------------------------------------------------
// B3 finish (l2 pass 2): zt = s_t[m]*raw_t, ztl = s_l[m]*raw_l; partial
// [sum (zt-z)^2 + (zt-ztl)^2]
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
finish_kernel(const float* __restrict__ z, const float* __restrict__ raw_t,
              const float* __restrict__ raw_l, const float* __restrict__ s_t,
              const float* __restrict__ s_l, float* __restrict__ zt,
              float* __restrict__ ztl, float* __restrict__ part, int n,
              int tile, int vec) {
  const Tile t(n, tile);
  const float st = s_t[blockIdx.y];
  const float sl = s_l[blockIdx.y];
  float acc[1] = {0.f};
  auto elem = [&](float zv, float rt, float rl, float& ot, float& ol) {
    ot = st * rt;
    ol = sl * rl;
    const float d1 = ot - zv;
    const float d2 = ot - ol;
    acc[0] += d1 * d1 + d2 * d2;
  };
  if (vec) {
    for (int j = t.start + 4 * threadIdx.x; j < t.end; j += 4 * kThreads) {
      float zv[4], rt[4], rl[4], ot[4], ol[4];
      load4(z + t.base + j, zv);
      load4(raw_t + t.base + j, rt);
      load4(raw_l + t.base + j, rl);
#pragma unroll
      for (int i = 0; i < 4; ++i) elem(zv[i], rt[i], rl[i], ot[i], ol[i]);
      store4(zt + t.base + j, ot);
      store4(ztl + t.base + j, ol);
    }
  } else {
    for (int j = t.start + threadIdx.x; j < t.end; j += kThreads) {
      elem(z[t.base + j], raw_t[t.base + j], raw_l[t.base + j],
           zt[t.base + j], ztl[t.base + j]);
    }
  }
  block_sum_store<1>(acc, t.partial(part, 1));
}

dim3 grid_of(int rows, int n, int tile) {
  return dim3(static_cast<unsigned>((n + tile - 1) / tile),
              static_cast<unsigned>(rows));
}

}  // namespace

extern "C" {

int adaseg_explore_launch(const float* z, const float* m, const float* sched,
                          float* out, float* part, int rows, int n, int tile,
                          int vec, int fuse_eta, float g0_sq, float d_alpha,
                          int has_box, float lo, float hi, int want_norm,
                          void* stream) {
  explore_kernel<<<grid_of(rows, n, tile), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      z, m, out, part, n, tile, vec, Step{sched, fuse_eta, g0_sq, d_alpha},
      Box{has_box, lo, hi}, want_norm);
  return static_cast<int>(cudaGetLastError());
}

int adaseg_anchor_launch(const float* z, const float* zt, const float* g,
                         const float* sched, float* ztl, float* part,
                         int rows, int n, int tile, int vec, int fuse_eta,
                         float g0_sq, float d_alpha, int has_box, float lo,
                         float hi, void* stream) {
  anchor_kernel<<<grid_of(rows, n, tile), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      z, zt, g, ztl, part, n, tile, vec, Step{sched, fuse_eta, g0_sq, d_alpha},
      Box{has_box, lo, hi});
  return static_cast<int>(cudaGetLastError());
}

int adaseg_finish_launch(const float* z, const float* raw_t,
                         const float* raw_l, const float* s_t,
                         const float* s_l, float* zt, float* ztl, float* part,
                         int rows, int n, int tile, int vec, void* stream) {
  finish_kernel<<<grid_of(rows, n, tile), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      z, raw_t, raw_l, s_t, s_l, zt, ztl, part, n, tile, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
