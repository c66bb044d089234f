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
// normalised once per block when asked, sit in shared memory (above 48 KB
// the launcher opts in to the larger carve-out, so M <= 57088 at 227 KB).
// A fleet whose weights do not fit there reads them from global memory
// through the read-only path instead (__ldg: the M weights are read by
// every block and stay in L1 and L2), normalised at each use by the same
// total, summed by one thread in row order as the shared path sums it, so
// both give the same bits. The ragged tail is masked by the column bound.
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
// Design: the grid is one block a (worker, column tile), the rows folded
// into gridDim.x (row-major), so a fleet of any size fits. A block owns one
// tile of one worker's row and reads that worker's scalars once; each
// thread owns columns of the tile (float4 when the row length and pointers
// allow it), the ragged tail is masked by the column bound, and no sum uses
// atomics. A dead worker's block reads no payload: it writes sent = 0 and
// copies its frozen residual.
//
// stats (B6) finishes each row in the same launch. What limited the first
// design (tiles of 2048 columns, a loop of float4 loads, partial maxima
// that the wrapper reduced with torch.amax): at (64, 16384) it reads 8 MiB,
// 2.5 us at 3.35 TB/s, and was held back by fixed costs, not bandwidth --
// two dependent round trips to memory per thread, then a second launch;
// 5.07 us on an H100 80GB HBM3 at 700 W for the first launch alone. Now a
// thread owns kStatsCols columns of each pass over its tile and issues all
// their loads (z and ef) before its first fmaxf; the wrapper sizes the
// tiles (a multiple of the kStatsStep columns of one pass) so that the grid
// is one wave of at most 4 blocks an SM (at (64, 16384) 4 tiles a row, 256
// blocks of one pass each; at a language-model leaf of 4 rows, 132 tiles a
// row, each a loop of passes). A block writes its maximum to part[m, tile];
// the row's last block to arrive, told by a per-row ticket, takes the
// maximum of the row's partials, writes out[m] and resets the ticket to 0,
// so the next launch, or a CUDA graph's replay, finds it at 0. A maximum is
// exact in any order. The tickets are an atomic counter, never a sum; two
// launches that share a ticket buffer must not run at the same time. The
// finish costs the last block three dependent round trips to memory (the
// fence, the ticket, the partials' read; warp 0 alone runs it), so at
// (64, 16384) the one launch takes 6.6 us on an H100 80GB HBM3 at 700 W,
// against 5.1 for the first design's first launch alone and 7.2 for its
// two through the wrapper; at a leaf of (4, 151936 x 896) 1.36 ms, 95% of
// the bytes bound. Finishing through a thread block
// cluster's shared memory instead (a row's tiles one cluster) saved a
// fraction of that in a trial, but takes only rows of at most 8 tiles.
//
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
// scalars: M <= 285 fits the default 48 KB, M <= 1350 the opt-in 227 KB.
// The ragged column edge is masked by the column bound.
//
// Larger fleets take a second, streamed path (trimmed_stream_kernel), which
// the wrapper picks when the staged slice would not fit: the same block of
// 32 columns x 8 row groups walks the rows in chunks of kTrimChunk, in row
// order. For each chunk a thread holds its kTrimChunkPass rows' values and
// rank counters in registers while all M rows of the column stream through
// shared memory in tiles of kTrimTile rows, double-buffered by cp.async
// (4-byte copies, so any row length or alignment is taken). Ranks add incl_k
// over k in order with the same tie-break, the chunk's keep flags go to
// shared memory, and one thread per column adds the chunk's kept w z and w
// in row order to a numerator and denominator carried across chunks: the
// staged kernel's survivor set and sum order, so both paths agree bit for
// bit where both run. Shared memory is fixed (37 KB), so the rows are not
// bounded by it. Like the Pallas kernel the path is O(M^2 n): each ordered
// pair one compare and a predicated add, twice the least work of 2.05 ms at
// M = 2048, n = 16384 and 49 ms at M = 10000 (one compare and one add an
// unordered pair at the f32 non-FMA issue rate), and it re-reads the column
// once a chunk (M / 128 times, 51 GB at M = 10000 -- 15 ms of HBM, under the
// compares). A select-based path (a per-column radix select of the b-th and
// (n_incl - 1 - b)-th (value, row) keys) would be O(M n), but it keeps the
// survivor set only for 0/1 incl, needs the column in shared memory or
// several passes over it, and trades the staged kernel's proven expressions
// for new ones; fleets this large sync rarely, so the streamed rank was
// chosen for its exact agreement with the staged path.
//
// outer_apply_launch replaces the Pallas kernel outer_apply (def :488,
// pallas_call :518, body _outer_kernel :240): the server's outer step on
// the (1, n) server leaf. Delta = merged - z, then momentum
// (m' = b m + Delta, z' = z + lr m'), Nesterov (z' = z + lr (Delta + b m'))
// or Adam (bias-corrected with t + 1), and one partial sum of Delta^2 per
// block. Bound on an H100: bytes (momentum and Nesterov read 3 and write 2
// rows, Adam reads 4 and writes 3: 0.10 and 0.14 us at n = 16384, 0.81 and
// 1.14 ms at the language model's embedding leaf, n = 151936 x 896), so at
// the game's size the launch itself sets the time. Every a b + c of the
// update is one __fmaf_rn and the other steps use _rn intrinsics, the
// roundings XLA gives the JAX package on the CPU; Adam's bias factors
// 1 - b^(t+1) come precomputed from the wrapper (one f32 pow each, shared
// with the plain version), and at lr = 1 the step is
// m' / ((1 - b1^(t+1)) (sqrt(v_hat) + eps)), XLA's rewrite of (a / b) / c.
//
// What limited the first design (1024-column tiles of scalar loads, one
// element a thread per step, one Delta^2 partial per block that the
// wrapper summed with torch.sum): at n = 16384, 16 blocks and two launches;
// at the embedding leaf 133k blocks of scalar loads. Design: a grid sized
// to the SMs (at most 4 blocks of 256 threads an SM) strides over passes of
// kOuterStep columns; a thread owns kOuterCols columns of a pass (float4
// when n % 4 == 0 and the pointers are 16-byte aligned) and issues all
// their loads before its arithmetic. Each thread sums its Delta^2 in pass
// order, the block in fixed shuffle trees (each warp, then the warps), and
// the last block to arrive (a ticket, reset to 0 after use) sums the
// blocks' partials in a fixed order into delta_sq (lane l of its first warp
// partials l, l + 32, ... in order, then a shuffle tree): one launch, reruns
// bit-identical. Finishing in the launch costs its last block three
// dependent round trips to memory (the fence, the ticket, the partials).
//
// empty_launch launches a kernel that does nothing, on a grid of the given
// blocks of 256 threads: the launch floor that chip_smoke.py times beside
// B6 and B11, whose small shapes take little more than a launch.
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
// Shared memory a block may opt in to on an H100 (227 KB).
constexpr size_t kMergeMaxSmem = 232448;

// Dynamic shared memory: the slices' partial sums (S > 1), then the rows
// weights (w given, G false). G: the weights are read from global memory.
template <int V, int S, bool G>
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
  if (w != nullptr && !G) {
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
  } else if (w != nullptr && normalize) {
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int i = 0; i < rows; ++i) s += __ldg(w + i);
      total = s;
    }
    __syncthreads();
  }
  // row i's weight: staged, or read through the read-only path (and divided
  // by the total as the staged weights were)
  auto weight = [&](int i) {
    if constexpr (G) {
      const float wi = __ldg(w + i);
      return normalize ? wi / total : wi;
    } else {
      return wsh[i];
    }
  };
  float acc[V] = {};
  for (int i0 = r0; i0 < r1;) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (i0 + u < r1) {
        const float wi = (w != nullptr) ? weight(i0 + u) : 1.f;
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

template <int V, int S, bool G>
int merge_launch_as(const float* z, const float* w, const float* recv,
                    const float* old, float* out, int rows, int n,
                    int normalize, unsigned blocks, size_t smem,
                    cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        merge_kernel<V, S, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  merge_kernel<V, S, G><<<blocks, kMergeThreads, smem, s>>>(
      z, w, recv, old, out, rows, n, normalize);
  return static_cast<int>(cudaGetLastError());
}

// The weights in shared memory where they fit beside the partial sums, else
// read from global memory (G).
template <int V, int S>
int merge_launch(const float* z, const float* w, const float* recv,
                 const float* old, float* out, int rows, int n, int normalize,
                 unsigned blocks, cudaStream_t s) {
  const size_t part = (S > 1 ? kMergeThreads * V : 0) * sizeof(float);
  const size_t staged = part + (w != nullptr ? rows : 0) * sizeof(float);
  if (staged <= kMergeMaxSmem) {
    return merge_launch_as<V, S, false>(z, w, recv, old, out, rows, n,
                                        normalize, blocks, staged, s);
  }
  return merge_launch_as<V, S, true>(z, w, recv, old, out, rows, n, normalize,
                                     blocks, part, s);
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
// Codec uplink (B6-B9): a block a (worker, column tile), V columns per thread
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

// The block's slice of its worker's row: columns [start, end) of row m,
// tile `index` of the row's `tiles`. The grid is one dimension, row-major
// (block m * tiles + index): gridDim.x takes 2^31 - 1 blocks where gridDim.y
// stops at 65535 rows.
struct RowTile {
  int m;
  int64_t base;
  int start;
  int end;
  unsigned index;
  unsigned tiles;
  __device__ RowTile(int n, int tile) {
    tiles = static_cast<unsigned>((n + tile - 1) / tile);
    m = static_cast<int>(blockIdx.x / tiles);
    index = blockIdx.x - static_cast<unsigned>(m) * tiles;
    base = static_cast<int64_t>(m) * n;
    start = static_cast<int>(index) * tile;
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

// A warp's maximum of v (v >= 0) and sum of v (a fixed shuffle tree), in
// lane 0.
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  return v;
}

// Called by warp 0 alone: lane 0 writes the block's partial v to *slot and
// counts the block in on the ticket. True in every lane when the block
// arrived last of the `blocks` that share the ticket; all their partials
// are then visible to it.
__device__ __forceinline__ bool arrived_last(float* slot, float v,
                                             unsigned* ticket,
                                             unsigned blocks) {
  unsigned prev = 0u;
  if (threadIdx.x == 0) {
    *slot = v;
    __threadfence();
    prev = atomicAdd(ticket, 1u);
  }
  return __shfl_sync(0xffffffffu, prev, 0) == blocks - 1;
}

// B6 stats: out[m] = max over row m of |w*z + ef|, in one launch.
constexpr int kStatsCols = 16;                          // a thread's, a pass
constexpr int kStatsStep = kUpThreads * kStatsCols;     // a block's, a pass

template <int V>
__global__ void __launch_bounds__(kUpThreads)
stats_kernel(const float* __restrict__ z, const float* __restrict__ w,
             const float* __restrict__ ef, float* __restrict__ part,
             unsigned* __restrict__ tickets, float* __restrict__ out, int n,
             int tile) {
  constexpr int U = kStatsCols / V;
  const RowTile t(n, tile);
  const bool has_w = w != nullptr;
  const bool has_ef = ef != nullptr;
  const float wv = has_w ? w[t.m] : 1.f;
  float acc = 0.f;
  for (int j0 = t.start; j0 < t.end; j0 += kStatsStep) {
    float zv[U][V], ev[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {     // every load of the pass first
      const int j = j0 + (u * kUpThreads + threadIdx.x) * V;
#pragma unroll
      for (int v = 0; v < V; ++v) zv[u][v] = ev[u][v] = 0.f;
      if (j < t.end) {
        load<V>(z + t.base + j, zv[u]);
        if (has_ef) load<V>(ef + t.base + j, ev[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        acc = fmaxf(acc, fabsf(effective(zv[u][v], ev[u][v], wv, has_w,
                                         has_ef)));
      }
    }
  }
  __shared__ float smem[kUpThreads / 32];
  acc = warp_max(acc);
  if ((threadIdx.x & 31) == 0) smem[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x >= 32) return;      // warp 0 finishes the block
  const float mx =
      warp_max(threadIdx.x < kUpThreads / 32 ? smem[threadIdx.x] : 0.f);
  const unsigned tiles = t.tiles;
  if (tiles == 1) {
    if (threadIdx.x == 0) out[t.m] = mx;
    return;
  }
  float* row = part + static_cast<int64_t>(t.m) * tiles;
  if (!arrived_last(row + t.index, mx, tickets + t.m, tiles)) return;
  float r = 0.f;
  for (unsigned i = threadIdx.x; i < tiles; i += 32) {
    r = fmaxf(r, __ldcg(row + i));
  }
  r = warp_max(r);
  if (threadIdx.x == 0) {
    out[t.m] = r;
    tickets[t.m] = 0u;
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

// B10's streamed path for fleets whose (M, 32) slice does not fit in shared
// memory: chunks of kTrimChunk rows ranked against the column streamed in
// tiles of kTrimTile rows.
constexpr int kTrimChunkPass = 16;                        // a thread's rows
constexpr int kTrimChunk = kTrimGroups * kTrimChunkPass;  // a chunk's rows
constexpr int kTrimTile = 64;

// 4-byte asynchronous copy into shared memory; zero-filled when !valid (src
// is then not read).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

enum RankMode { kRankBefore, kRankAfter, kRankPerPair };

// Adds incl_k to rank[u] for the kn rows k of a streamed tile (tz: this
// lane's column, stride kTrimCols) that rank below row i_u = i_0 + 8u; kk0
// is k - i_0 at the tile's first row. Before: every k < i_u (z_k <= z_i);
// after: every k > i_u (z_k < z_i); per pair: either, by the row index.
template <int kMode>
__device__ __forceinline__ void rank_tile(const float* tz, const float* ti,
                                          int kn, int kk0,
                                          const float (&zi)[kTrimChunkPass],
                                          float (&rank)[kTrimChunkPass]) {
#pragma unroll 4
  for (int k = 0; k < kn; ++k) {
    const float zk = tz[k * kTrimCols];
    const float ik = ti[k];
#pragma unroll
    for (int u = 0; u < kTrimChunkPass; ++u) {
      bool below;
      if constexpr (kMode == kRankBefore) {
        below = zk <= zi[u];
      } else if constexpr (kMode == kRankAfter) {
        below = zk < zi[u];
      } else {
        below = kk0 + k < kTrimGroups * u ? zk <= zi[u] : zk < zi[u];
      }
      if (below) rank[u] = __fadd_rn(rank[u], ik);
    }
  }
}

__global__ void __launch_bounds__(kTrimThreads)
trimmed_stream_kernel(const float* __restrict__ z, const float* __restrict__ w,
                      const float* __restrict__ incl,
                      const float* __restrict__ recv,
                      const float* __restrict__ old, float* __restrict__ out,
                      int rows, int n, float trim) {
  __shared__ float tile_z[2][kTrimTile * kTrimCols];
  __shared__ float tile_incl[2][kTrimTile];
  __shared__ float chunk_z[kTrimChunk * kTrimCols];
  __shared__ uint8_t keep_sh[kTrimChunk * kTrimCols];
  __shared__ float mean_sh[kTrimCols];
  __shared__ float n_incl_sh;

  const int lane = threadIdx.x % kTrimCols;
  const int group = threadIdx.x / kTrimCols;
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kTrimCols + lane;
  const bool in = col < n;
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int i = 0; i < rows; ++i) s = __fadd_rn(s, incl[i]);
    n_incl_sh = s;
  }
  __syncthreads();
  const float n_incl = n_incl_sh;
  const float b = fminf(trim, floorf(__fmul_rn(__fsub_rn(n_incl, 1.f), 0.5f)));
  const float hi = __fsub_rn(__fsub_rn(n_incl, 1.f), b);

  // Tile kt of the column: rows kt * kTrimTile + group + 8 r of this lane's
  // column, and (threads 0..kTrimTile-1) the tile's incl.
  const int tiles = (rows + kTrimTile - 1) / kTrimTile;
  auto fetch = [&](int kt) {
    const int k0 = kt * kTrimTile;
    float* dst = tile_z[kt & 1];
    for (int r = group; r < kTrimTile; r += kTrimGroups) {
      const bool ok = in && k0 + r < rows;
      cp_async4(dst + r * kTrimCols + lane,
                ok ? z + static_cast<int64_t>(k0 + r) * n + col : z, ok);
    }
    if (threadIdx.x < kTrimTile) {
      const bool ok = k0 + threadIdx.x < rows;
      cp_async4(tile_incl[kt & 1] + threadIdx.x,
                ok ? incl + k0 + threadIdx.x : incl, ok);
    }
    cp_async_commit();
  };

  float num = 0.f, den = 0.f;         // column sums, carried across chunks
  for (int c0 = 0; c0 < rows; c0 += kTrimChunk) {
    // this thread's rows i_u = c0 + group + 8u, increasing in u
    float zi[kTrimChunkPass], rank[kTrimChunkPass];
#pragma unroll
    for (int u = 0; u < kTrimChunkPass; ++u) {
      const int r = group + kTrimGroups * u;
      const int i = c0 + r;
      zi[u] = (in && i < rows) ? z[static_cast<int64_t>(i) * n + col] : 0.f;
      chunk_z[r * kTrimCols + lane] = zi[u];
      rank[u] = 0.f;
    }
    fetch(0);
    for (int kt = 0; kt < tiles; ++kt) {
      if (kt + 1 < tiles) {
        fetch(kt + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* tz = tile_z[kt & 1] + lane;
      const float* ti = tile_incl[kt & 1];
      const int k0 = kt * kTrimTile;
      const int kn = min(kTrimTile, rows - k0);
      // z_k ranks below z_i when z_k < z_i, or z_k = z_i and k < i: a tile
      // wholly before the chunk's rows compares with <=, one wholly after
      // with <, and one that overlaps them settles it per pair.
      const int kk0 = k0 - c0 - group;  // k - i_0 at the tile's first row
      if (k0 + kTrimTile <= c0) {
        rank_tile<kRankBefore>(tz, ti, kn, kk0, zi, rank);
      } else if (k0 >= c0 + kTrimChunk) {
        rank_tile<kRankAfter>(tz, ti, kn, kk0, zi, rank);
      } else {
        rank_tile<kRankPerPair>(tz, ti, kn, kk0, zi, rank);
      }
      __syncthreads();                // the buffer is refilled next
    }
#pragma unroll
    for (int u = 0; u < kTrimChunkPass; ++u) {
      const int r = group + kTrimGroups * u;
      const int i = c0 + r;
      if (i < rows) {
        keep_sh[r * kTrimCols + lane] =
            incl[i] > 0.f && rank[u] >= b && rank[u] <= hi;
      }
    }
    __syncthreads();
    if (group == 0) {
      const int rn = min(kTrimChunk, rows - c0);
      for (int r = 0; r < rn; ++r) {
        if (keep_sh[r * kTrimCols + lane]) {
          const float wi = w[c0 + r];
          num = __fadd_rn(num, __fmul_rn(wi, chunk_z[r * kTrimCols + lane]));
          den = __fadd_rn(den, wi);
        }
      }
    }
    __syncthreads();                  // chunk_z and keep_sh are refilled next
  }
  if (group == 0) mean_sh[lane] = __fdiv_rn(num, fmaxf(den, 1e-30f));
  __syncthreads();
  if (!in) return;
  const float mean = mean_sh[lane];
  for (int i = group; i < rows; i += kTrimGroups) {
    const int64_t off = static_cast<int64_t>(i) * n + col;
    out[off] = (recv == nullptr || recv[i] > 0.f) ? mean : old[off];
  }
}

// ---------------------------------------------------------------------------
// B11 outer step on the (1, n) server leaf: a grid sized to the SMs strides
// over passes of kOuterStep columns, V columns a load (V = 4: float4).
// ---------------------------------------------------------------------------
constexpr int kOuterThreads = 256;
constexpr int kOuterCols = 8;                             // a thread's, a pass
constexpr int kOuterStep = kOuterThreads * kOuterCols;    // a block's, a pass
enum OuterKind { kMomentum = 0, kNesterov = 1, kAdam = 2 };

template <int V>
__global__ void __launch_bounds__(kOuterThreads)
outer_kernel(const float* __restrict__ g, const float* __restrict__ z,
             const float* __restrict__ m0, const float* __restrict__ m1,
             const float* __restrict__ bias, float* __restrict__ z_out,
             float* __restrict__ m0_out, float* __restrict__ m1_out,
             float* __restrict__ part, unsigned* __restrict__ ticket,
             float* __restrict__ delta_sq, int n, int kind, float lr,
             float beta1, float beta2, float eps, float c1, float c2) {
  constexpr int U = kOuterCols / V;
  const bool adam = kind == kAdam;
  const float bc1 = adam ? bias[0] : 1.f;
  const float bc2 = adam ? bias[1] : 1.f;
  float acc = 0.f;
  for (int64_t j0 = static_cast<int64_t>(blockIdx.x) * kOuterStep; j0 < n;
       j0 += static_cast<int64_t>(gridDim.x) * kOuterStep) {
    float gv[U][V], zv[U][V], av[U][V], bv[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {     // every load of the pass first
      const int64_t j = j0 + (u * kOuterThreads + threadIdx.x) * V;
      if (j < n) {
        load<V>(g + j, gv[u]);
        load<V>(z + j, zv[u]);
        load<V>(m0 + j, av[u]);
        if (adam) load<V>(m1 + j, bv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t j = j0 + (u * kOuterThreads + threadIdx.x) * V;
      if (j >= n) continue;
#pragma unroll
      for (int v = 0; v < V; ++v) {   // in place: gv <- z', av <- m', bv <- v'
        const float zz = zv[u][v];
        const float d = __fsub_rn(gv[u][v], zz);
        if (adam) {
          const float mn = __fmaf_rn(beta1, av[u][v], __fmul_rn(c1, d));
          const float vn = __fmaf_rn(beta2, bv[u][v],
                                     __fmul_rn(__fmul_rn(c2, d), d));
          const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(vn, bc2)), eps);
          const float step = lr == 1.f
              ? __fdiv_rn(mn, __fmul_rn(bc1, den))
              : __fdiv_rn(__fmul_rn(lr, __fdiv_rn(mn, bc1)), den);
          gv[u][v] = __fadd_rn(zz, step);
          av[u][v] = mn;
          bv[u][v] = vn;
        } else {
          const float mn = __fmaf_rn(beta1, av[u][v], d);
          const float st = kind == kNesterov ? __fmaf_rn(beta1, mn, d) : mn;
          gv[u][v] = __fmaf_rn(lr, st, zz);
          av[u][v] = mn;
        }
        acc = __fadd_rn(acc, __fmul_rn(d, d));
      }
      store<V>(z_out + j, gv[u]);
      store<V>(m0_out + j, av[u]);
      if (adam) store<V>(m1_out + j, bv[u]);
    }
  }
  __shared__ float smem[kOuterThreads / 32];
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) smem[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x >= 32) return;      // warp 0 finishes the block
  const float s =
      warp_sum(threadIdx.x < kOuterThreads / 32 ? smem[threadIdx.x] : 0.f);
  const unsigned blocks = gridDim.x;
  if (blocks == 1) {
    if (threadIdx.x == 0) *delta_sq = s;
    return;
  }
  if (!arrived_last(part + blockIdx.x, s, ticket, blocks)) return;
  float r = 0.f;                      // lane l: partials l, l + 32, ...
  for (unsigned i = threadIdx.x; i < blocks; i += 32) {
    r = __fadd_rn(r, __ldcg(part + i));
  }
  r = warp_sum(r);
  if (threadIdx.x == 0) {
    *delta_sq = r;
    *ticket = 0u;
  }
}

__global__ void empty_kernel() {}

// The uplink kernels' grid: a block a (row, tile), rows folded into
// gridDim.x. False when the blocks exceed gridDim.x's 2^31 - 1.
bool uplink_grid(int rows, int n, int tile, dim3* grid) {
  const int64_t blocks = static_cast<int64_t>(rows) * ((n + tile - 1) / tile);
  if (rows <= 0 || blocks > INT32_MAX) return false;
  *grid = dim3(static_cast<unsigned>(blocks));
  return true;
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
// 16-byte aligned (the uint8 mask 4-byte aligned). Any number of rows, up
// to 2^31 - 1 blocks of (row, tile); more is refused here.

// part is (rows, ceil(n / tile)) scratch, tickets (rows,) arrival counters
// at 0 (left at 0), out (rows,); tile best a multiple of kStatsStep.
int uplink_stats_launch(const float* z, const float* w, const float* ef,
                        float* part, unsigned* tickets, float* out, int rows,
                        int n, int tile, int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid;
  if (!uplink_grid(rows, n, tile, &grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (vec) {
    stats_kernel<4><<<grid, kUpThreads, 0, s>>>(z, w, ef, part, tickets, out,
                                                n, tile);
  } else {
    stats_kernel<1><<<grid, kUpThreads, 0, s>>>(z, w, ef, part, tickets, out,
                                                n, tile);
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
  dim3 grid;
  if (!uplink_grid(rows, n, tile, &grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  dim3 grid;
  if (!uplink_grid(rows, n, tile, &grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  dim3 grid;
  if (!uplink_grid(rows, n, tile, &grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
// receives). path 0 stages the block's slice in shared memory: rows
// (4 (kTrimCols + 3) + kTrimCols) + 4 (kTrimCols + 1) bytes, above 48 KB
// by the opt-in carve-out (227 KB at most, so rows <= 1350; more is refused
// here). path 1 streams the column through 37 KB (any rows). The wrapper
// picks path 0 where it fits (kernel.py::trimmed_path); both give the same
// bits.
int trimmed_merge_launch(const float* z, const float* w, const float* incl,
                         const float* recv, const float* old, float* out,
                         int rows, int n, float trim, int path, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((n + kTrimCols - 1) / kTrimCols);
  if (path == 1) {
    trimmed_stream_kernel<<<blocks, kTrimThreads, 0, s>>>(
        z, w, incl, recv, old, out, rows, n, trim);
    return static_cast<int>(cudaGetLastError());
  }
  if (path != 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      static_cast<size_t>(rows) * (sizeof(float) * (kTrimCols + 3) + kTrimCols) +
      sizeof(float) * (kTrimCols + 1);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        trimmed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  trimmed_kernel<<<blocks, kTrimThreads, smem, s>>>(z, w, incl, recv, old, out,
                                                    rows, n, trim);
  return static_cast<int>(cudaGetLastError());
}

// B11. kind: 0 momentum, 1 Nesterov, 2 Adam. m1, m1_out and bias (the two
// bias factors, device memory) are read or written for Adam only; beta1 is
// the momentum coefficient of the other two. c1 = f32(1 - beta1), c2 =
// f32(1 - beta2). part is (blocks,) scratch, ticket one arrival counter at
// 0 (left at 0), delta_sq one float. vec = 1 takes the float4 path: n a
// multiple of 4, pointers 16-byte aligned.
int outer_apply_launch(const float* g, const float* z, const float* m0,
                       const float* m1, const float* bias, float* z_out,
                       float* m0_out, float* m1_out, float* part,
                       unsigned* ticket, float* delta_sq, int n, int blocks,
                       int vec, int kind, float lr, float beta1, float beta2,
                       float eps, float c1, float c2, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    outer_kernel<4><<<blocks, kOuterThreads, 0, s>>>(
        g, z, m0, m1, bias, z_out, m0_out, m1_out, part, ticket, delta_sq, n,
        kind, lr, beta1, beta2, eps, c1, c2);
  } else {
    outer_kernel<1><<<blocks, kOuterThreads, 0, s>>>(
        g, z, m0, m1, bias, z_out, m0_out, m1_out, part, ticket, delta_sq, n,
        kind, lr, beta1, beta2, eps, c1, c2);
  }
  return static_cast<int>(cudaGetLastError());
}

// A kernel that does nothing, on blocks x 256 threads: the launch floor.
int empty_launch(int blocks, void* stream) {
  empty_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
