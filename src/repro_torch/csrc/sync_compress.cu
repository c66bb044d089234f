// Fused Line-5/7 sync kernels for Hopper (sm_90a): the server merge and
// the four codec uplink passes.
//
// merge_stacked_launch replaces the Pallas kernel merge_stacked of
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
// What limited the first design (a thread per float4 column group, summing
// all M rows in one loop, then writing them): at n=16384 it ran 32 blocks of
// 128 threads, on 32 of the 132 SMs, and a thread had one or two 16-byte
// loads in flight. That is a few hundred KB in flight where Little's law
// asks for ~2 MB at HBM latency: 15.2 us on an H100 80GB HBM3 at 700 W,
// 1.6x torch.matmul(w.expand(M, M), z).
//
// Design: a block of 256 threads is S row slices x 256/S lanes, a lane a
// float4 column group (one column when the row length or the pointers do
// not allow float4). A slice sums w_i z_i over its own ceil(M/S) rows in
// row order, a batch of 8 rows loaded into registers before their FMAs (the
// first batch before the weights are staged, which its loads do not need).
// The slices' partial sums meet in shared memory, every thread adds them in
// slice order 0..S-1, and each slice writes the sum down its own rows (old
// for a row that does not receive). At (64, 16384) S = 8: 128 blocks, 8
// warps an SM, the whole 4 MiB of z in flight at once. The launcher doubles
// S, up to 8, while the grid has fewer than 128 blocks and every slice keeps
// a batch of rows, so a leaf of few rows (the language models' M = 4) stays
// one slice of whole columns, the first design's shape. Sum order: rows in
// order within a slice, then the slices in order; fixed, with no atomics, so
// reruns are bit-identical (S = 1 is the first design's order). The weights,
// normalised once per block when asked, sit in shared memory; the ragged
// tail is masked by the column bound.
//
// The codec uplink kernels replace the Pallas kernels of the same file that
// run through _uplink_call (pallas_call :313):
//   uplink_stats_launch    <- uplink_stats    (def :329, body _stats_kernel :103)
//   quantize_uplink_launch <- quantize_uplink (def :344, body _quantize_kernel
//                                              :115, stream _kernel_uniform :83)
//   eff_uplink_launch      <- eff_uplink      (def :373, body _eff_kernel :145)
//   mask_uplink_launch     <- mask_uplink     (def :386, body _mask_kernel :155)
// They act on one worker-stacked leaf (M, n) per launch with per-worker
// scalars: the weight w, the quantizer scale, the aliveness and the two key
// words. Bound on an H100: HBM bandwidth for all four (per element, stats
// reads 8 B, eff 12 B, mask 13 B, quantize 16 B), and for quantize also the
// integer throughput: its in-kernel threefry2x32 and the uniform's mantissa
// cost 70 live int32 operations per element, which at 64 lanes per SM per
// clock is of the same order as its 16 B of traffic.
//
// Design: the grid is (column tiles x workers). A block owns one tile of one
// worker's row and reads that worker's scalars once; each thread owns
// columns of the tile (float4 when the row length and pointers allow it),
// the ragged tail is masked by the column bound, and nothing uses atomics.
// stats writes one partial maximum per block into (M, tiles) and the caller
// takes the maximum over the tiles (exact in any order). A dead worker's
// block reads no payload: it writes sent = 0 and copies its frozen residual.
// The effective message eff = w*z + ef is rounded once (__fmaf_rn), as XLA
// rounds the fused multiply-add it emits, and every later step uses the
// _rn intrinsics so that nvcc's contraction cannot change a rounding: a
// 1-ulp change of eff can flip a stochastic rounding decision and move the
// element by a whole quantization level. Quantize generates its uniforms
// in-register from the element's column index: threefry2x32(k0, k1, j, 0),
// first output word, top 23 bits as the mantissa of [1, 2) minus 1 -- the
// stream of the plain version, bit for bit.
//
// trimmed_merge_launch replaces the Pallas kernel trimmed_merge_stacked of
// the same file (def :446, pallas_call :477, body _trimmed_kernel :178): the
// robust server merge. Per column j and row i the stable rank is
//   rank_ij = sum_k incl_k [z_kj < z_ij or (z_kj = z_ij and k < i)];
// with b = min(trim, floor((n_incl - 1) / 2)), rows with incl_i > 0 and
// b <= rank_ij <= n_incl - 1 - b survive, and every row receives
// sum_i w_i keep_ij z_ij / max(sum_i w_i keep_ij, 1e-30) (rows with recv = 0
// keep old instead). Bound on an H100: bytes. At (64, 16384) it moves 8 MiB
// (2.5 us at 3.35 TB/s; 3.8 us with recv/old). The ranks need at least
// 64 * 63 / 2 * 16384 = 3.3e7 unordered pairs, each one compare (which
// settles both ranks) and one add, 6.6e7 operations: 2.0 us at the f32
// non-FMA issue rate of 132 SMs x 128 lanes x 1980 MHz. This design ranks
// each ordered pair on its own, a compare and a predicated add, 4.0 us.
//
// What limited the first design (a block of 64 threads owning 64 columns,
// one per thread, each ranking all M rows of its column): at (64, 16384)
// 256 blocks of 2 warps, about four warps an SM, each thread a dependent
// 64 x 64 compare-and-add chain -- a latency chain, 66.8 us on an H100
// 80GB HBM3 at 700 W against the 2.5 us bound.
//
// Design: a block of 256 threads owns 32 columns and stages its (M, 32)
// slice in shared memory. Thread x is column x % 32, so loads, shared reads
// and stores are coalesced and conflict-free, and row group x / 32 of 8:
// each thread ranks the rows i = group + 8r (r < ceil(M / 8)) against the
// whole staged column, 8 rows a pass (one shared load feeds 8 compares and
// 8 independent add chains; the tie-break on the row index is settled by
// splitting the k loop at the thread's rows, so a pair costs one compare
// and a predicated add), and writes their keep flags to shared memory.
// After one barrier one thread per column adds the kept rows' w z and w in
// row order 0..M-1 -- the plain version's survivor set exactly, and the
// first design's sum order, with no atomics. Ranks add the 0/1 incl over
// k in order, as before, so the output is bit-identical to the first
// design's. Then all 256 threads write the M output rows (old
// where recv = 0). At n = 16384 that is 512 blocks of 8 warps. The slice
// takes 4 M (32 + 3) + 32 M bytes of shared memory (the column, w, incl,
// recv, and a byte of keep flag a row and column) and 132 bytes of
// scalars: M <= 285 fits the default 48 KB, M <= 1350 the opt-in 227 KB,
// larger fleets are refused by the wrapper. The ragged column edge is
// masked by the column bound.
//
// outer_apply_launch replaces the Pallas kernel outer_apply (def :488,
// pallas_call :518, body _outer_kernel :240): the server's outer step on
// the (1, n) server leaf. Delta = merged - z, then momentum
// (m' = b m + Delta, z' = z + lr m'), Nesterov (z' = z + lr (Delta + b m'))
// or Adam (bias-corrected with t + 1), and one partial sum of Delta^2 per
// block. Bound on an H100: bytes (momentum and Nesterov read 3 and write 2
// rows, Adam reads 4 and writes 3: 0.10 and 0.14 us at n = 16384), so at
// the game's size the launch itself sets the time. Design: elementwise
// over column tiles; every a b + c of the update is one __fmaf_rn and the
// other steps use _rn intrinsics, the roundings XLA gives the JAX package
// on the CPU; Adam's bias factors 1 - b^(t+1) come precomputed from the
// wrapper (one f32 pow each, shared with the plain version), and at
// lr = 1 the step is m' / ((1 - b1^(t+1)) (sqrt(v_hat) + eps)), XLA's
// rewrite of (a / b) / c. The Delta^2 partial is a fixed-order block
// reduction; the wrapper sums the partials.
//
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int V>
__device__ __forceinline__ void load(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = p[0];
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

// ---------------------------------------------------------------------------
// B5 merge: S row slices x kMergeThreads / S lanes a block, V columns a lane
// (V = 4: float4 loads and stores), kMergeBatch rows loaded at a time.
// ---------------------------------------------------------------------------
constexpr int kMergeThreads = 256;
constexpr int kMergeBatch = 8;
constexpr int kMergeMaxSlices = 8;
constexpr int kMergeFillBlocks = 128;  // about one block for each of 132 SMs

// Dynamic shared memory: the slices' partial sums (S > 1), then the rows
// weights (w given).
template <int V, int S>
__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const float* __restrict__ z, const float* __restrict__ w,
             const float* __restrict__ recv, const float* __restrict__ old,
             float* __restrict__ out, int rows, int n, int normalize) {
  constexpr int kLanes = kMergeThreads / S;
  constexpr int U = kMergeBatch;
  extern __shared__ __align__(16) float sh[];
  float* part = sh;
  float* wsh = sh + (S > 1 ? kMergeThreads * V : 0);
  __shared__ float total;
  const int lane = threadIdx.x % kLanes;
  const int slice = threadIdx.x / kLanes;
  const int64_t col = (static_cast<int64_t>(blockIdx.x) * kLanes + lane) * V;
  const bool active = col < n;
  const int per = (rows + S - 1) / S;
  const int r0 = min(slice * per, rows);
  const int r1 = min(r0 + per, rows);

  float zv[U][V] = {};
  auto load_batch = [&](int i0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (active && i0 + u < r1) {
        load<V>(z + static_cast<int64_t>(i0 + u) * n + col, zv[u]);
      }
    }
  };
  load_batch(r0);
  if (w != nullptr) {
    for (int i = threadIdx.x; i < rows; i += kMergeThreads) wsh[i] = w[i];
    __syncthreads();
    if (normalize) {
      if (threadIdx.x == 0) {
        float s = 0.f;
        for (int i = 0; i < rows; ++i) s += wsh[i];
        total = s;
      }
      __syncthreads();
      for (int i = threadIdx.x; i < rows; i += kMergeThreads) wsh[i] /= total;
      __syncthreads();
    }
  }
  float acc[V] = {};
  for (int i0 = r0; i0 < r1;) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (i0 + u < r1) {
        const float wi = (w != nullptr) ? wsh[i0 + u] : 1.f;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          acc[v] = (w != nullptr) ? acc[v] + wi * zv[u][v] : acc[v] + zv[u][v];
        }
      }
    }
    i0 += U;
    if (i0 < r1) load_batch(i0);
  }
  if constexpr (S > 1) {
#pragma unroll
    for (int v = 0; v < V; ++v) part[threadIdx.x * V + v] = acc[v];
    __syncthreads();
    const int used = (rows + per - 1) / per;  // slices that hold rows
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = part[lane * V + v];
    for (int k = 1; k < used; ++k) {
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] += part[(k * kLanes + lane) * V + v];
    }
  }
  if (!active) return;
  for (int i0 = r0; i0 < r1; i0 += U) {
    float ov[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (i0 + u < r1 && recv != nullptr && !(recv[i0 + u] > 0.f)) {
        load<V>(old + static_cast<int64_t>(i0 + u) * n + col, ov[u]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) ov[u][v] = acc[v];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (i0 + u < r1) store<V>(out + static_cast<int64_t>(i0 + u) * n + col, ov[u]);
    }
  }
}

template <int V, int S>
int merge_launch(const float* z, const float* w, const float* recv,
                 const float* old, float* out, int rows, int n, int normalize,
                 unsigned blocks, cudaStream_t s) {
  const size_t smem = ((S > 1 ? kMergeThreads * V : 0) + (w != nullptr ? rows : 0))
                      * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        merge_kernel<V, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  merge_kernel<V, S><<<blocks, kMergeThreads, smem, s>>>(z, w, recv, old, out,
                                                         rows, n, normalize);
  return static_cast<int>(cudaGetLastError());
}

template <int V>
int merge_dispatch(const float* z, const float* w, const float* recv,
                   const float* old, float* out, int rows, int n, int normalize,
                   cudaStream_t s) {
  const int64_t lanes = (n + V - 1) / V;
  auto blocks = [&](int slices) {
    return static_cast<unsigned>((lanes * slices + kMergeThreads - 1) / kMergeThreads);
  };
  int slices = 1;
  while (slices < kMergeMaxSlices
         && (rows + kMergeBatch - 1) / kMergeBatch >= 2 * slices
         && blocks(slices) < kMergeFillBlocks) {
    slices *= 2;
  }
  const unsigned b = blocks(slices);
  switch (slices) {
    case 1: return merge_launch<V, 1>(z, w, recv, old, out, rows, n, normalize, b, s);
    case 2: return merge_launch<V, 2>(z, w, recv, old, out, rows, n, normalize, b, s);
    case 4: return merge_launch<V, 4>(z, w, recv, old, out, rows, n, normalize, b, s);
    default: return merge_launch<V, 8>(z, w, recv, old, out, rows, n, normalize, b, s);
  }
}

// ---------------------------------------------------------------------------
// Codec uplink (B6-B9): grid (column tiles x workers), V columns per thread
// and step (V = 4: float4 loads and stores).
// ---------------------------------------------------------------------------
constexpr int kUpThreads = 256;

template <int V>
__device__ __forceinline__ void load(const uint8_t* p, uint8_t (&v)[V]) {
  if constexpr (V == 4) {
    const uchar4 t = *reinterpret_cast<const uchar4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = p[0];
  }
}

// The block's slice of its worker's row: columns [start, end) of row m.
struct RowTile {
  int m;
  int64_t base;
  int start;
  int end;
  __device__ RowTile(int n, int tile) {
    m = blockIdx.y;
    base = static_cast<int64_t>(m) * n;
    start = blockIdx.x * tile;
    end = min(start + tile, n);
  }
};

// The codec's effective message w*z + ef, rounded once.
__device__ __forceinline__ float effective(float z, float e, float w,
                                           bool has_w, bool has_ef) {
  if (has_w) return has_ef ? __fmaf_rn(w, z, e) : __fmul_rn(w, z);
  return has_ef ? __fadd_rn(z, e) : z;
}

__device__ __forceinline__ bool row_alive(const float* alive, int m) {
  return alive == nullptr || alive[m] > 0.f;
}

// A dead worker's tile: sent = 0 and the residual copied through (zeros
// when there is none).
template <int V>
__device__ __forceinline__ void dead_row(const RowTile& t, const float* ef,
                                         float* sent, float* ef_out) {
  for (int j = t.start + V * threadIdx.x; j < t.end; j += V * kUpThreads) {
    float zero[V] = {};
    store<V>(sent + t.base + j, zero);
    if (ef_out != nullptr) {
      float ev[V] = {};
      if (ef != nullptr) load<V>(ef + t.base + j, ev);
      store<V>(ef_out + t.base + j, ev);
    }
  }
}

__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r) ^ x0;
}

// threefry2x32 (20 rounds) of the counter (x0, 0) under the key (k0, k1),
// k2 = k0 ^ k1 ^ 0x1BD11BDA; returns the first output word.
__device__ __forceinline__ uint32_t threefry_y0(uint32_t k0, uint32_t k1,
                                                uint32_t k2, uint32_t x0) {
  uint32_t x1 = k1;
  x0 += k0;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k1; x1 += k2 + 1u;
  mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
  x0 += k2; x1 += k0 + 2u;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k0; x1 += k1 + 3u;
  mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
  x0 += k1; x1 += k2 + 4u;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  return x0 + k2;
}

// The codec stream's uniform in [0, 1) for column j.
__device__ __forceinline__ float codec_uniform(uint32_t k0, uint32_t k1,
                                               uint32_t k2, uint32_t j) {
  const uint32_t bits = threefry_y0(k0, k1, k2, j);
  return __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.f);
}

// B6 stats: part[m, tile] = max over the tile of |w*z + ef|.
template <int V>
__global__ void __launch_bounds__(kUpThreads)
stats_kernel(const float* __restrict__ z, const float* __restrict__ w,
             const float* __restrict__ ef, float* __restrict__ part, int n,
             int tile) {
  const RowTile t(n, tile);
  const bool has_w = w != nullptr;
  const bool has_ef = ef != nullptr;
  const float wv = has_w ? w[t.m] : 1.f;
  float acc = 0.f;
  for (int j = t.start + V * threadIdx.x; j < t.end; j += V * kUpThreads) {
    float zv[V], ev[V] = {};
    load<V>(z + t.base + j, zv);
    if (has_ef) load<V>(ef + t.base + j, ev);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      acc = fmaxf(acc, fabsf(effective(zv[i], ev[i], wv, has_w, has_ef)));
    }
  }
  __shared__ float smem[kUpThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc = fmaxf(acc, __shfl_down_sync(0xffffffffu, acc, off));
  }
  if ((threadIdx.x & 31) == 0) smem[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float mx = 0.f;
    for (int i = 0; i < kUpThreads / 32; ++i) mx = fmaxf(mx, smem[i]);
    part[static_cast<int64_t>(t.m) * gridDim.x + blockIdx.x] = mx;
  }
}

// B7 quantize: eff = w*z + ef; y = |eff| / scale * levels; round y down or
// up by comparing the stream's uniform with y - floor(y); sent = sign(eff) *
// level * (scale * (1 / levels)); ef_out = eff - sent. The expression order
// is that of _quantize_kernel, with the division by the constant levels
// rewritten as XLA rewrites it.
template <int V>
__global__ void __launch_bounds__(kUpThreads)
quantize_kernel(const float* __restrict__ z, const float* __restrict__ w,
                const float* __restrict__ ef, const float* __restrict__ scale,
                const float* __restrict__ alive,
                const uint32_t* __restrict__ keys, float* __restrict__ sent,
                float* __restrict__ ef_out, int n, int tile, float levels) {
  const RowTile t(n, tile);
  if (!row_alive(alive, t.m)) {
    dead_row<V>(t, ef, sent, ef_out);
    return;
  }
  const bool has_w = w != nullptr;
  const bool has_ef = ef != nullptr;
  const float wv = has_w ? w[t.m] : 1.f;
  const float sc = scale[t.m];
  // scale / levels as XLA computes it: times the f32 reciprocal of levels
  const float step = __fmul_rn(sc, __frcp_rn(levels));
  const uint32_t k0 = keys[2 * t.m];
  const uint32_t k1 = keys[2 * t.m + 1];
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  for (int j = t.start + V * threadIdx.x; j < t.end; j += V * kUpThreads) {
    float zv[V], ev[V] = {}, sv[V], nv[V];
    load<V>(z + t.base + j, zv);
    if (has_ef) load<V>(ef + t.base + j, ev);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float e = effective(zv[i], ev[i], wv, has_w, has_ef);
      const float y = __fmul_rn(__fdiv_rn(fabsf(e), sc), levels);
      const float lo = floorf(y);
      const float u = codec_uniform(k0, k1, k2, static_cast<uint32_t>(j + i));
      const float up = u < __fsub_rn(y, lo) ? 1.f : 0.f;
      const float mag = __fmul_rn(__fadd_rn(lo, up), step);
      const float sg = e > 0.f ? 1.f : (e < 0.f ? -1.f : 0.f);
      sv[i] = __fmul_rn(sg, mag);
      nv[i] = __fsub_rn(e, sv[i]);
    }
    store<V>(sent + t.base + j, sv);
    if (ef_out != nullptr) store<V>(ef_out + t.base + j, nv);
  }
}

// B8 eff: out = w*z + ef.
template <int V>
__global__ void __launch_bounds__(kUpThreads)
eff_kernel(const float* __restrict__ z, const float* __restrict__ w,
           const float* __restrict__ ef, float* __restrict__ out, int n,
           int tile) {
  const RowTile t(n, tile);
  const bool has_w = w != nullptr;
  const bool has_ef = ef != nullptr;
  const float wv = has_w ? w[t.m] : 1.f;
  for (int j = t.start + V * threadIdx.x; j < t.end; j += V * kUpThreads) {
    float zv[V], ev[V] = {}, ov[V];
    load<V>(z + t.base + j, zv);
    if (has_ef) load<V>(ef + t.base + j, ev);
#pragma unroll
    for (int i = 0; i < V; ++i) ov[i] = effective(zv[i], ev[i], wv, has_w, has_ef);
    store<V>(out + t.base + j, ov);
  }
}

// B9 mask: sent = mask ? eff : 0, ef_out = eff - sent; dead rows send 0 and
// keep ef.
template <int V>
__global__ void __launch_bounds__(kUpThreads)
mask_kernel(const float* __restrict__ eff, const uint8_t* __restrict__ mask,
            const float* __restrict__ ef, const float* __restrict__ alive,
            float* __restrict__ sent, float* __restrict__ ef_out, int n,
            int tile) {
  const RowTile t(n, tile);
  if (!row_alive(alive, t.m)) {
    dead_row<V>(t, ef, sent, ef_out);
    return;
  }
  for (int j = t.start + V * threadIdx.x; j < t.end; j += V * kUpThreads) {
    float ev[V], sv[V], nv[V];
    uint8_t mv[V];
    load<V>(eff + t.base + j, ev);
    load<V>(mask + t.base + j, mv);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      sv[i] = mv[i] != 0 ? ev[i] : 0.f;
      nv[i] = __fsub_rn(ev[i], sv[i]);
    }
    store<V>(sent + t.base + j, sv);
    if (ef_out != nullptr) store<V>(ef_out + t.base + j, nv);
  }
}

// ---------------------------------------------------------------------------
// B10 robust merge: 32 columns x 8 row groups a block, the block's (M, 32)
// slice staged in shared memory.
// ---------------------------------------------------------------------------
constexpr int kTrimCols = 32;
constexpr int kTrimGroups = 8;
constexpr int kTrimThreads = kTrimCols * kTrimGroups;
constexpr int kTrimPass = 8;   // rows a thread ranks per pass over the column

__global__ void __launch_bounds__(kTrimThreads)
trimmed_kernel(const float* __restrict__ z, const float* __restrict__ w,
               const float* __restrict__ incl, const float* __restrict__ recv,
               const float* __restrict__ old, float* __restrict__ out,
               int rows, int n, float trim) {
  extern __shared__ float sh[];
  float* col_sh = sh;                         // rows x kTrimCols
  float* w_sh = col_sh + rows * kTrimCols;    // rows
  float* incl_sh = w_sh + rows;               // rows
  float* recv_sh = incl_sh + rows;            // rows (1 = receives)
  float* mean_sh = recv_sh + rows;            // kTrimCols
  float* n_incl_sh = mean_sh + kTrimCols;     // 1
  uint8_t* keep_sh = reinterpret_cast<uint8_t*>(n_incl_sh + 1);  // rows x kTrimCols

  const int lane = threadIdx.x % kTrimCols;
  const int group = threadIdx.x / kTrimCols;
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kTrimCols + lane;
  const bool in = col < n;
  for (int i = threadIdx.x; i < rows; i += kTrimThreads) {
    w_sh[i] = w[i];
    incl_sh[i] = incl[i];
    recv_sh[i] = (recv == nullptr || recv[i] > 0.f) ? 1.f : 0.f;
  }
  for (int k = group; k < rows; k += kTrimGroups) {
    col_sh[k * kTrimCols + lane] = in ? z[static_cast<int64_t>(k) * n + col] : 0.f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int i = 0; i < rows; ++i) s = __fadd_rn(s, incl_sh[i]);
    *n_incl_sh = s;
  }
  __syncthreads();
  const float n_incl = *n_incl_sh;
  const float b = fminf(trim, floorf(__fmul_rn(__fsub_rn(n_incl, 1.f), 0.5f)));
  const float hi = __fsub_rn(__fsub_rn(n_incl, 1.f), b);

  const float* mine = col_sh + lane;          // this column, stride kTrimCols
  for (int i0 = group; i0 < rows; i0 += kTrimGroups * kTrimPass) {
    // rows i_u = i0 + 8u, increasing in u
    float zi[kTrimPass], rank[kTrimPass];
#pragma unroll
    for (int u = 0; u < kTrimPass; ++u) {
      const int i = i0 + kTrimGroups * u;
      zi[u] = i < rows ? mine[i * kTrimCols] : 0.f;
      rank[u] = 0.f;
    }
    // z_k ranks below z_i when z_k < z_i, or z_k = z_i and k < i; so for
    // k < i it is z_k <= z_i and for k >= i z_k < z_i. Segment seg of the
    // k loop runs from i_(seg-1) to i_seg, where rows u < seg are at or
    // before k: one compare and a predicated add a pair, in k order.
    int k = 0;
#pragma unroll
    for (int seg = 0; seg <= kTrimPass; ++seg) {
      const int k_end = seg < kTrimPass ? min(i0 + kTrimGroups * seg, rows) : rows;
#pragma unroll 4
      for (; k < k_end; ++k) {
        const float zk = mine[k * kTrimCols];
        const float ik = incl_sh[k];
#pragma unroll
        for (int u = 0; u < kTrimPass; ++u) {
          if (u < seg ? zk < zi[u] : zk <= zi[u]) rank[u] = __fadd_rn(rank[u], ik);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kTrimPass; ++u) {
      const int i = i0 + kTrimGroups * u;
      if (i < rows) {
        keep_sh[i * kTrimCols + lane] =
            incl_sh[i] > 0.f && rank[u] >= b && rank[u] <= hi;
      }
    }
  }
  __syncthreads();
  if (group == 0) {
    float num = 0.f, den = 0.f;
#pragma unroll 8
    for (int i = 0; i < rows; ++i) {
      if (keep_sh[i * kTrimCols + lane]) {
        num = __fadd_rn(num, __fmul_rn(w_sh[i], mine[i * kTrimCols]));
        den = __fadd_rn(den, w_sh[i]);
      }
    }
    mean_sh[lane] = __fdiv_rn(num, fmaxf(den, 1e-30f));
  }
  __syncthreads();
  if (!in) return;
  const float mean = mean_sh[lane];
  for (int i = group; i < rows; i += kTrimGroups) {
    const int64_t off = static_cast<int64_t>(i) * n + col;
    out[off] = recv_sh[i] > 0.f ? mean : old[off];
  }
}

// ---------------------------------------------------------------------------
// B11 outer step: elementwise over column tiles of the (1, n) server leaf.
// ---------------------------------------------------------------------------
constexpr int kOuterThreads = 256;
enum OuterKind { kMomentum = 0, kNesterov = 1, kAdam = 2 };

__global__ void __launch_bounds__(kOuterThreads)
outer_kernel(const float* __restrict__ g, const float* __restrict__ z,
             const float* __restrict__ m0, const float* __restrict__ m1,
             const float* __restrict__ bias, float* __restrict__ z_out,
             float* __restrict__ m0_out, float* __restrict__ m1_out,
             float* __restrict__ part, int n, int tile, int kind, float lr,
             float beta1, float beta2, float eps, float c1, float c2) {
  const int start = blockIdx.x * tile;
  const int end = min(start + tile, n);
  const float bc1 = kind == kAdam ? bias[0] : 1.f;
  const float bc2 = kind == kAdam ? bias[1] : 1.f;
  float acc = 0.f;
  for (int j = start + threadIdx.x; j < end; j += kOuterThreads) {
    const float zz = z[j];
    const float d = __fsub_rn(g[j], zz);
    float zn;
    if (kind == kAdam) {
      const float mn = __fmaf_rn(beta1, m0[j], __fmul_rn(c1, d));
      const float vn = __fmaf_rn(beta2, m1[j], __fmul_rn(__fmul_rn(c2, d), d));
      const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(vn, bc2)), eps);
      const float step = lr == 1.f
          ? __fdiv_rn(mn, __fmul_rn(bc1, den))
          : __fdiv_rn(__fmul_rn(lr, __fdiv_rn(mn, bc1)), den);
      zn = __fadd_rn(zz, step);
      m0_out[j] = mn;
      m1_out[j] = vn;
    } else {
      const float mn = __fmaf_rn(beta1, m0[j], d);
      const float st = kind == kNesterov ? __fmaf_rn(beta1, mn, d) : mn;
      zn = __fmaf_rn(lr, st, zz);
      m0_out[j] = mn;
    }
    z_out[j] = zn;
    acc = __fadd_rn(acc, __fmul_rn(d, d));
  }
  __shared__ float smem[kOuterThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
  }
  if ((threadIdx.x & 31) == 0) smem[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int i = 0; i < kOuterThreads / 32; ++i) s = __fadd_rn(s, smem[i]);
    part[blockIdx.x] = s;
  }
}

dim3 uplink_grid(int rows, int n, int tile) {
  return dim3(static_cast<unsigned>((n + tile - 1) / tile),
              static_cast<unsigned>(rows));
}

}  // namespace

extern "C" {

// w, recv and old may be null (unit weights / every row receives). vec = 1
// takes the float4 path: n a multiple of 4, pointers 16-byte aligned.
int merge_stacked_launch(const float* z, const float* w, const float* recv,
                         const float* old, float* out, int rows, int n,
                         int normalize, int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? merge_dispatch<4>(z, w, recv, old, out, rows, n, normalize, s)
             : merge_dispatch<1>(z, w, recv, old, out, rows, n, normalize, s);
}

// The uplink launchers: w, ef and alive may be null (no weight / no
// residual / every worker alive), and so may ef_out (no residual written).
// vec = 1 takes the float4 path: n and tile multiples of 4, pointers
// 16-byte aligned (the uint8 mask 4-byte aligned).

// part is (rows, ceil(n / tile)).
int uplink_stats_launch(const float* z, const float* w, const float* ef,
                        float* part, int rows, int n, int tile, int vec,
                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = uplink_grid(rows, n, tile);
  if (vec) {
    stats_kernel<4><<<grid, kUpThreads, 0, s>>>(z, w, ef, part, n, tile);
  } else {
    stats_kernel<1><<<grid, kUpThreads, 0, s>>>(z, w, ef, part, n, tile);
  }
  return static_cast<int>(cudaGetLastError());
}

// keys is (rows, 2) uint32; scale is (rows,), already clamped.
int quantize_uplink_launch(const float* z, const float* w, const float* ef,
                           const float* scale, const float* alive,
                           const uint32_t* keys, float* sent, float* ef_out,
                           int rows, int n, int tile, int vec, float levels,
                           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = uplink_grid(rows, n, tile);
  if (vec) {
    quantize_kernel<4><<<grid, kUpThreads, 0, s>>>(
        z, w, ef, scale, alive, keys, sent, ef_out, n, tile, levels);
  } else {
    quantize_kernel<1><<<grid, kUpThreads, 0, s>>>(
        z, w, ef, scale, alive, keys, sent, ef_out, n, tile, levels);
  }
  return static_cast<int>(cudaGetLastError());
}

int eff_uplink_launch(const float* z, const float* w, const float* ef,
                      float* out, int rows, int n, int tile, int vec,
                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = uplink_grid(rows, n, tile);
  if (vec) {
    eff_kernel<4><<<grid, kUpThreads, 0, s>>>(z, w, ef, out, n, tile);
  } else {
    eff_kernel<1><<<grid, kUpThreads, 0, s>>>(z, w, ef, out, n, tile);
  }
  return static_cast<int>(cudaGetLastError());
}

// mask is (rows, n) uint8, nonzero = keep; ef is read for dead rows only.
int mask_uplink_launch(const float* eff, const uint8_t* mask, const float* ef,
                       const float* alive, float* sent, float* ef_out,
                       int rows, int n, int tile, int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = uplink_grid(rows, n, tile);
  if (vec) {
    mask_kernel<4><<<grid, kUpThreads, 0, s>>>(eff, mask, ef, alive, sent,
                                                ef_out, n, tile);
  } else {
    mask_kernel<1><<<grid, kUpThreads, 0, s>>>(eff, mask, ef, alive, sent,
                                                ef_out, n, tile);
  }
  return static_cast<int>(cudaGetLastError());
}

// B10. w and incl are (rows,); recv and old may be null (every row
// receives). The shared slice takes rows (4 (kTrimCols + 3) + kTrimCols)
// + 4 (kTrimCols + 1) bytes; above 48 KB the launcher opts in to the
// larger carve-out (227 KB at most).
int trimmed_merge_launch(const float* z, const float* w, const float* incl,
                         const float* recv, const float* old, float* out,
                         int rows, int n, float trim, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem =
      static_cast<size_t>(rows) * (sizeof(float) * (kTrimCols + 3) + kTrimCols) +
      sizeof(float) * (kTrimCols + 1);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        trimmed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = static_cast<unsigned>((n + kTrimCols - 1) / kTrimCols);
  trimmed_kernel<<<blocks, kTrimThreads, smem, s>>>(z, w, incl, recv, old, out,
                                                    rows, n, trim);
  return static_cast<int>(cudaGetLastError());
}

// B11. kind: 0 momentum, 1 Nesterov, 2 Adam. m1, m1_out and bias (the two
// bias factors, device memory) are read or written for Adam only; beta1 is
// the momentum coefficient of the other two. c1 = f32(1 - beta1), c2 =
// f32(1 - beta2). part is (ceil(n / tile),).
int outer_apply_launch(const float* g, const float* z, const float* m0,
                       const float* m1, const float* bias, float* z_out,
                       float* m0_out, float* m1_out, float* part, int n,
                       int tile, int kind, float lr, float beta1, float beta2,
                       float eps, float c1, float c2, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((n + tile - 1) / tile);
  outer_kernel<<<blocks, kOuterThreads, 0, s>>>(
      g, z, m0, m1, bias, z_out, m0_out, m1_out, part, n, tile, kind, lr,
      beta1, beta2, eps, c1, c2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
