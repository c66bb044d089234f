// Flash-attention forward for Hopper (sm_90a): blockwise online softmax.
//
// Replaces the Pallas kernel of src/repro/kernels/flash_attention/kernel.py:
//   flash_attention_launch <- flash_attention (kernel.py:97, pallas_call :134)
//
// q is (B, H, S, D), k and v are (B, Kh, T, D), all float32 and contiguous;
// query head h reads KV head h / (H / Kh) (GQA), as the reference's index
// map (bh // g) does. The output is (B, H, S, D).
//
// Design: one thread block per (query tile of 64 rows, batch*head). The
// query tile stays in shared memory; the block walks the key/value tiles
// of 64 rows, staging each in shared memory, and keeps the running max m,
// the normalizer l and the output accumulator of its rows in registers
// (the reference's VMEM scratch). A tile that no query of the block can
// see is skipped exactly when the reference's `reachable` is false:
// causal, k_start <= q_start + 63; sliding window, k_start + 63 >
// q_start - window. Masked logits become NEG_INF = -1e30 and their
// probabilities exact zeros; at the end l is floored at 1e-30, so the
// arithmetic is the reference's (_flash_kernel, kernel.py:32-95) at a
// 64 x 64 blocking. Rows past S are not written and keys past T are
// masked, so any S and T work without padding. Query tiles are issued
// last-first: under a causal mask they carry the most key tiles.
//
// 256 threads as a 16 x 16 grid (ty, tx): a thread holds logits for query
// rows ty + 16r and keys tx + 16c (r, c < 4), and the output of rows
// ty + 16r and columns 4tx + 64j (a float4 each, j < D / 64). Row maxima
// and sums are reduced over the 16 lanes of a half-warp with shuffles.
// Products are f32 FMAs (no tensor cores, no TF32); exp and tanh are the
// accurate expf and tanhf. D = 64 and D = 128 are compiled; any other
// head dimension is refused with cudaErrorInvalidValue.
//
// Bound on an H100 at the qwen2-0.5b path's shape (B = 1, H = 14, Kh = 2,
// S = T = 1024, D = 64, causal): 4 * D flops per (query, visible key) pair
// is 1.88 GFLOP, 28 us at 67 TFLOP/s f32; the bytes (q, k, v read once, o
// written once) are 8.4 MB, 2.5 us at 3.35 TB/s. It is bound by operations.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBq = 64;
constexpr int kBk = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int heads;
  int kv_heads;
  int s;
  int t;
  float scale;
  int causal;
  int has_window;
  int window;
  int has_cap;
  float cap;
};

template <int D>
struct Layout {
  static constexpr int kLd = D + 4;      // Q and K row stride (floats)
  static constexpr int kLdP = kBk + 4;   // P row stride
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBq * kLd;
  static constexpr int kV = kK + kBk * kLd;
  static constexpr int kP = kV + kBk * D;
  static constexpr size_t kBytes = sizeof(float) * (kP + kBq * kLdP);
};

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// Copies a (64, D) tile of rows [row0, row0 + 64) of a (rows, D) matrix
// into shared memory with row stride ld; rows at or past `rows` are zeros.
template <int D>
__device__ __forceinline__ void load_tile(const float* __restrict__ src,
                                          int row0, int rows, float* dst,
                                          int ld) {
  constexpr int kVec = D / 4;
  for (int i = threadIdx.x; i < 64 * kVec; i += kThreads) {
    const int r = i / kVec;
    const int c = (i % kVec) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows) {
      val = *reinterpret_cast<const float4*>(
          src + static_cast<int64_t>(row0 + r) * D + c);
    }
    *reinterpret_cast<float4*>(dst + r * ld + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(Params p) {
  using L = Layout<D>;
  constexpr int kCols = D / 64;          // float4 output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem + L::kQ;
  float* ks = smem + L::kK;
  float* vs = smem + L::kV;
  float* ps = smem + L::kP;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int q_start = (gridDim.x - 1 - blockIdx.x) * kBq;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int kvh = b * p.kv_heads + h / (p.heads / p.kv_heads);
  const float* q = p.q + static_cast<int64_t>(bh) * p.s * D;
  const float* k = p.k + static_cast<int64_t>(kvh) * p.t * D;
  const float* v = p.v + static_cast<int64_t>(kvh) * p.t * D;
  float* o = p.o + static_cast<int64_t>(bh) * p.s * D;

  load_tile<D>(q, q_start, p.s, qs, L::kLd);

  float m[4], l[4];
  float4 acc[4][kCols];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const int num_k = (p.t + kBk - 1) / kBk;
  for (int kt = 0; kt < num_k; ++kt) {
    const int k_start = kt * kBk;
    bool reachable = true;
    if (p.causal) reachable = k_start <= q_start + kBq - 1;
    if (p.has_window) {
      reachable = reachable && (k_start + kBk - 1 > q_start - p.window);
    }
    if (!reachable) continue;             // uniform across the block

    __syncthreads();                      // the last tile's readers are done
    load_tile<D>(k, k_start, p.t, ks, L::kLd);
    load_tile<D>(v, k_start, p.t, vs, D);
    __syncthreads();

    // logits of rows ty + 16r against keys tx + 16c
    float sc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[r][c] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        qv[r] = *reinterpret_cast<const float4*>(qs + (ty + 16 * r) * L::kLd + d);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        kv[c] = *reinterpret_cast<const float4*>(ks + (tx + 16 * c) * L::kLd + d);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float a = sc[r][c];
          a = fmaf(qv[r].x, kv[c].x, a);
          a = fmaf(qv[r].y, kv[c].y, a);
          a = fmaf(qv[r].z, kv[c].z, a);
          a = fmaf(qv[r].w, kv[c].w, a);
          sc[r][c] = a;
        }
      }
    }

    // scale, soft-cap, mask; online-softmax update of each row
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q_start + ty + 16 * r;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k_start + tx + 16 * c;
        float s = sc[r][c] * p.scale;
        if (p.has_cap) s = p.cap * tanhf(s / p.cap);
        bool keep = kj < p.t;
        if (p.causal) keep = keep && kj <= qi;
        if (p.has_window) keep = keep && kj > qi - p.window;
        ok[c] = keep;
        sc[r][c] = keep ? s : kNegInf;
        mx = fmaxf(mx, sc[r][c]);
      }
      const float m_new = fmaxf(m[r], half_warp_max(mx));
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float pr = ok[c] ? expf(sc[r][c] - m_new) : 0.f;
        sum += pr;
        ps[(ty + 16 * r) * L::kLdP + tx + 16 * c] = pr;
      }
      l[r] = l[r] * alpha + half_warp_sum(sum);
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        acc[r][j].x *= alpha;
        acc[r][j].y *= alpha;
        acc[r][j].z *= alpha;
        acc[r][j].w *= alpha;
      }
    }
    __syncthreads();

    // acc += P V over the tile's keys
#pragma unroll 2
    for (int jk = 0; jk < kBk; jk += 4) {
      float4 pv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pv[r] = *reinterpret_cast<const float4*>(ps + (ty + 16 * r) * L::kLdP + jk);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const float4 vv = *reinterpret_cast<const float4*>(
              vs + (jk + u) * D + 64 * j + 4 * tx);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float w = u == 0 ? pv[r].x : u == 1 ? pv[r].y
                          : u == 2 ? pv[r].z : pv[r].w;
            acc[r][j].x = fmaf(w, vv.x, acc[r][j].x);
            acc[r][j].y = fmaf(w, vv.y, acc[r][j].y);
            acc[r][j].z = fmaf(w, vv.z, acc[r][j].z);
            acc[r][j].w = fmaf(w, vv.w, acc[r][j].w);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q_start + ty + 16 * r;
    if (qi >= p.s) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float4 a = acc[r][j];
      *reinterpret_cast<float4*>(o + static_cast<int64_t>(qi) * D + 64 * j + 4 * tx) =
          make_float4(a.x / den, a.y / den, a.z / den, a.w / den);
    }
  }
}

template <int D>
cudaError_t launch(const Params& p, int batch_heads, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Layout<D>::kBytes));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(static_cast<unsigned>((p.s + kBq - 1) / kBq),
                  static_cast<unsigned>(batch_heads));
  flash_fwd_kernel<D><<<grid, kThreads, Layout<D>::kBytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int flash_attention_launch(const float* q, const float* k, const float* v,
                           float* o, int batch, int heads, int kv_heads,
                           int s, int t, int d, float scale, int causal,
                           int has_window, int window, int has_cap, float cap,
                           void* stream) {
  const Params p{q, k, v, o, heads, kv_heads, s, t, scale, causal,
                 has_window, window, has_cap, cap};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (d == 64) {
    err = launch<64>(p, batch * heads, st);
  } else if (d == 128) {
    err = launch<128>(p, batch * heads, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // extern "C"
