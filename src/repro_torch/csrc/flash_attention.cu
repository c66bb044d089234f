// Flash-attention forward for Hopper (sm_90a): blockwise online softmax
// with both products on the tensor cores in split TF32 ("3xTF32").
//
// Replaces the Pallas kernel of src/repro/kernels/flash_attention/kernel.py:
//   flash_attention_launch <- flash_attention (kernel.py:97, pallas_call :134)
//
// q is (B, H, S, D), k and v are (B, Kh, T, D), all float32 and contiguous;
// query head h reads KV head h / (H / Kh) (GQA), as the reference's index
// map (bh // g) does. The output is (B, H, S, D).
//
// Semantics: one thread block per (query tile of 64 rows, batch*head). The
// block walks the key/value tiles of 32 rows and keeps the running max m,
// the normalizer l and the output accumulator of its rows in registers
// (the reference's VMEM scratch). A tile that no query of the block can
// see is skipped exactly when the reference's `reachable` is false:
// causal, k_start <= q_start + 63; sliding window, k_start + 31 >
// q_start - window. Masked logits become NEG_INF = -1e30 and their
// probabilities exact zeros; at the end l is floored at 1e-30, so the
// arithmetic is the reference's (_flash_kernel, kernel.py:32-95) at a
// 64 x 32 blocking. Rows past S are not written and keys past T are
// masked, so any S and T work without padding. exp and tanh are the
// accurate expf and tanhf. D = 64, 128 and 256 are compiled; any other
// head dimension is refused with cudaErrorInvalidValue.
//
// Bound on an H100 at the qwen2-0.5b path's shape (B = 1, H = 14, Kh = 2,
// S = T = 1024, D = 64, causal): 4 * D flops per (query, visible key) pair
// is 1.88 GFLOP, 28 us at 67 TFLOP/s of f32 FMA; on the tensor cores the
// three TF32 products below are 5.6 GFLOP, 11.4 us at 495 TFLOP/s dense
// TF32, beside ~1.8 us of MUFU for the exponentials. The bytes (q, k, v
// read once, o written once) are 8.4 MB, 2.5 us at 3.35 TB/s. The bound is
// the faster route's: 11.4 us.
//
// What limited the first design (a 16 x 16 thread grid of FFMA on 4 x 4
// register tiles): each float4 shared load fed four FMAs, so shared-memory
// bandwidth set the pace; K and V were copied synchronously between two
// barriers; P made a block-wide round trip through shared memory. It ran
// at 12.9 TFLOP/s of the 67.
//
// Design. Products: both (Q.K^T and P.V) are mma.sync.m16n8k8 TF32 with
// f32 accumulation. Plain TF32 keeps 10 mantissa bits, ~5e-4 relative, so
// every operand x is split into x_hi = tf32(x) and x_lo = tf32(x - x_hi)
// (round to nearest, ties away, as cvt.rna) and a product is a_lo.b_hi +
// a_hi.b_lo + a_hi.b_hi; the dropped a_lo.b_lo and the rounding of x_lo
// are ~2^-21 relative, close to f32. Q is held once per block in shared
// memory, as it is; Q, K, V and P are split as their fragments are read.
// (Q split once into hi and lo tiles in shared memory was 3-7% slower on
// an H100 80GB HBM3 at 700 W: 65.1 against 62.6 us at the path's shape,
// 123.0 against 114.8 us at D = 128, 73.4 against 69.3 us at granite's;
// chip_smoke.py --flash on both layouts in one call.)
// Warps: 16 query rows a warp, 4 row warps a block, times S key/value
// streams (S = 4 at D = 64, 2 at D = 128): stream s takes the block's
// reachable tiles s, s + S, ..., so the few query tiles that see the most
// keys are spread over S times the warps, and each warp keeps its own
// online softmax (m, l, acc) in registers. Each stream runs its own
// pipeline, synchronised by a named barrier of its 4 warps only, so the
// streams drift apart and one's softmax overlaps another's products (a
// block-wide barrier per tile would keep them in step). At the end
// the streams hand their state to stream 0 through shared memory, merged
// in stream order.
// A tile that none of a warp's rows sees is skipped by that warp (it would
// multiply by alpha = 1 and add zeros); one all of them see needs no mask.
// P never leaves the warp: the m16n8 accumulator gives a thread the
// logits of columns 2t and 2t+1 of its rows, where the A operand of P.V
// wants columns t and t+4. The sum over keys does not care which key sits
// at which k index, so the P.V step of keys 8j..8j+7 maps k index t to key
// 2t and k index t+4 to key 2t+1; the thread's probabilities are then its
// A fragment as they stand, and the B fragment reads V's rows 2t and 2t+1.
// Loads: each stream double-buffers its K and V tiles in shared memory
// with cp.async (16 B a thread), its next tile loading while the current
// one computes. Q and K rows are strided D + 16 floats and read 16
// bytes at a time (one read feeds two k-steps of Q.K^T, whose d order is
// permuted the same way in both operands); V rows are strided D + 4. Every
// fragment read is conflict-free. Blocks are issued heaviest first across
// all heads: under a causal mask the last query tiles carry the most key
// tiles. No atomics and a fixed order of every sum, so reruns are
// bit-identical.
//
// D = 256 (recurrentgemma's 16 query heads over one KV head of 256): the
// D = 128 layout at 256 would hold two streams' double-buffered K/V tiles
// beside Q, 342,016 bytes of shared memory against the 232,448 a block may
// have, and its accumulator is 128 registers a thread. So it runs one
// key/value stream (4 row warps, 128 threads): 17,408 + 2 x 17,024
// floats, 205,824 bytes, one block an SM. Bound at (B = 1, H = 16, Kh = 1,
// S = T = 1024, D = 256, causal): 8.60 GFLOP, 52.1 us at three TF32
// terms (128 us of f32 FMA); bytes 35.7 MB, 10.6 us.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBq = 64;                  // query rows a block
constexpr int kBk = 32;                  // keys a tile
constexpr int kRowWarps = kBq / 16;      // 16 query rows a warp
constexpr int kNt = kBk / 8;             // n-tiles of 8 keys in a tile
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
  int batch_heads;
  int num_q;                             // query tiles per head
};

// Key/value streams of a block: 4 at D = 64 (512 threads, the register
// file's 128 a thread), 2 at D = 128 (256 threads), 1 at D = 256 (128
// threads).
template <int D>
struct Layout {
  static constexpr int kStreams = D == 64 ? 4 : (D == 128 ? 2 : 1);
  static constexpr int kThreads = 32 * kRowWarps * kStreams;
  static constexpr int kLdQK = D + 16;   // Q and K rows: 16-byte reads, conflict-free
  static constexpr int kLdV = D + 4;     // V rows: 4-byte reads of rows 2t, 2t + 1
  static constexpr int kQ = 0;           // Q, as it is
  static constexpr int kKV = kBq * kLdQK;  // stream s, buffer b at kKV + (2s + b) kTile
  static constexpr int kV = kBk * kLdQK;          // V's offset in a tile
  static constexpr int kTile = kV + kBk * kLdV;
  static constexpr int kMerge = 4 + 4 * (D / 8);  // floats a lane hands over
  static constexpr size_t kBytes = sizeof(float) * (kKV + 2 * kStreams * kTile);
  static_assert((kStreams - 1) * kRowWarps * 32 * kMerge <= 2 * kStreams * kTile,
                "the merge reuses the K/V buffers");
  static_assert(kBytes <= 232448, "more shared memory than a block may have");
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(in ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// cvt.rna.tf32.f32's rounding (to nearest, ties away from zero) of a finite
// float in two integer operations: the sign-magnitude bits plus half the
// 13 dropped bits, truncated. ptxas expands the cvt itself into more,
// guarding NaN, which the operands here are not.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to ~2^-21 relative, both TF32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// d += a b on one m16n8k8 tile, TF32 operands, f32 accumulation.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[n0 + n] += a b[n] for N n-tiles in split TF32: the small terms
// first, each term over all N n-tiles before the next, so consecutive mmas
// are independent.
template <int N, int M>
__device__ __forceinline__ void mma3(float (&acc)[M][4], int n0,
                                     const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4],
                                     const uint32_t (&bhi)[N][2],
                                     const uint32_t (&blo)[N][2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma(acc[n0 + n], alo, bhi[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma(acc[n0 + n], ahi, blo[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma(acc[n0 + n], ahi, bhi[n]);
}

// Barrier of the 4 row warps of one key/value stream (ids 1..S; 0 is
// __syncthreads).
__device__ __forceinline__ void stream_sync(int stream) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(stream + 1), "n"(32 * kRowWarps)
               : "memory");
}

__device__ __forceinline__ bool visible(const Params& p, int qi, int kj) {
  bool keep = kj < p.t;
  if (p.causal) keep = keep && kj <= qi;
  if (p.has_window) keep = keep && kj > qi - p.window;
  return keep;
}

template <int D>
__global__ void __launch_bounds__(Layout<D>::kThreads, 1)
flash_fwd_kernel(Params p) {
  using L = Layout<D>;
  constexpr int kS = L::kStreams;
  constexpr int kDt = D / 8;             // n-tiles of P.V
  extern __shared__ __align__(16) float smem[];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;               // fragment row group
  const int t = lane & 3;                // thread in the group
  const int rw = warp % kRowWarps;       // row warp: rows 16 rw .. 16 rw + 15
  const int stream = warp / kRowWarps;
  const int row = rw * 16 + g;           // rows row and row + 8 of the tile
  // heaviest query tiles of every head first
  const int q_start = (p.num_q - 1 - static_cast<int>(blockIdx.x) / p.batch_heads) * kBq;
  const int bh = static_cast<int>(blockIdx.x) % p.batch_heads;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int kvh = b * p.kv_heads + h / (p.heads / p.kv_heads);
  const float* q = p.q + static_cast<int64_t>(bh) * p.s * D;
  const float* k = p.k + static_cast<int64_t>(kvh) * p.t * D;
  const float* v = p.v + static_cast<int64_t>(kvh) * p.t * D;
  float* o = p.o + static_cast<int64_t>(bh) * p.s * D;
  const int q_lo = q_start + rw * 16;    // this warp's rows
  const int q_hi = q_lo + 15;

  // The reachable key tiles are one contiguous range [kt0, kt1); stream s
  // takes tiles kt0 + s, kt0 + s + S, ...: its i-th is kt0 + s + i S.
  const int num_k = (p.t + kBk - 1) / kBk;
  int kt1 = num_k;
  if (p.causal) kt1 = min(num_k, (q_start + kBq - 1) / kBk + 1);
  int kt0 = 0;
  if (p.has_window) {
    while (kt0 < kt1 && !(kt0 * kBk + kBk - 1 > q_start - p.window)) ++kt0;
  }
  const int ntiles = kt1 - kt0 > stream ? (kt1 - kt0 - stream + kS - 1) / kS : 0;

  // The stream's i-th K and V tiles into its buffer `buf`, by its threads
  auto load_tile = [&](int i, int buf) {
    constexpr int kVec = D / 4;
    const int kt = kt0 + stream + i * kS;
    float* tile = smem + L::kKV + (2 * stream + buf) * L::kTile;
    for (int c = threadIdx.x - 32 * kRowWarps * stream; c < 2 * kBk * kVec;
         c += 32 * kRowWarps) {
      const int is_v = c / (kBk * kVec);
      const int r = (c / kVec) % kBk;
      const int col = (c % kVec) * 4;
      const int key = kt * kBk + r;
      const bool in = key < p.t;
      cp_async16(tile + (is_v ? L::kV + r * L::kLdV : r * L::kLdQK) + col,
                 (is_v ? v : k) + static_cast<int64_t>(in ? key : 0) * D + col, in);
    }
  };
  if (ntiles > 0) load_tile(0, 0);
  cp_async_commit();

  // Q, as it is; rows past S are zeros
  for (int i = threadIdx.x; i < kBq * D / 4; i += L::kThreads) {
    const int r = i / (D / 4);
    const int c = (i % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q_start + r < p.s) {
      x = *reinterpret_cast<const float4*>(q + static_cast<int64_t>(q_start + r) * D + c);
    }
    *reinterpret_cast<float4*>(smem + L::kQ + r * L::kLdQK + c) = x;
  }
  __syncthreads();

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[kDt][4];
#pragma unroll
  for (int n = 0; n < kDt; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }

  // Each stream runs its own pipeline, synchronised within its 4 warps
  // only, so the streams drift apart and one's softmax overlaps another's
  // products.
  for (int i = 0; i < ntiles; ++i) {
    const int buf = i & 1;
    if (i + 1 < ntiles) {
      load_tile(i + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    stream_sync(stream);
    const int kt = kt0 + stream + i * kS;
    const int k_start = kt * kBk;
    // A tile none of the warp's rows sees changes nothing (alpha = 1, no
    // probability): skip it. One all of them see needs no mask.
    const bool none = (p.causal && k_start > q_hi) ||
                      (p.has_window && k_start + kBk - 1 <= q_lo - p.window);
    if (!none) {
      const bool all = k_start + kBk <= p.t &&
                       (!p.causal || k_start + kBk - 1 <= q_lo) &&
                       (!p.has_window || k_start > q_hi - p.window);
      const float* ks = smem + L::kKV + (2 * stream + buf) * L::kTile;
      const float* vs = ks + L::kV;

      // logits of rows (row, row + 8) against keys 8n + 2t, 8n + 2t + 1.
      // The sum over d does not care which d sits at which k index: step
      // 2kk takes k index t to d = 16kk + 4t and t + 4 to 16kk + 4t + 1,
      // step 2kk + 1 the next two, so one 16-byte read of a Q or K row
      // feeds two k-steps.
      float sc[kNt][4];
#pragma unroll
      for (int n = 0; n < kNt; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
      }
#pragma unroll 2
      for (int kk = 0; kk < D / 16; ++kk) {
        const int col = 16 * kk + 4 * t;
        uint32_t a0hi[4], a0lo[4], a1hi[4], a1lo[4];
        const float4 q0 = *reinterpret_cast<const float4*>(smem + L::kQ + row * L::kLdQK + col);
        const float4 q8 = *reinterpret_cast<const float4*>(smem + L::kQ + (row + 8) * L::kLdQK + col);
        split(q0.x, a0hi[0], a0lo[0]);
        split(q8.x, a0hi[1], a0lo[1]);
        split(q0.y, a0hi[2], a0lo[2]);
        split(q8.y, a0hi[3], a0lo[3]);
        split(q0.z, a1hi[0], a1lo[0]);
        split(q8.z, a1hi[1], a1lo[1]);
        split(q0.w, a1hi[2], a1lo[2]);
        split(q8.w, a1hi[3], a1lo[3]);
        uint32_t b0hi[kNt][2], b0lo[kNt][2], b1hi[kNt][2], b1lo[kNt][2];
#pragma unroll
        for (int n = 0; n < kNt; ++n) {
          const float4 kv = *reinterpret_cast<const float4*>(ks + (8 * n + g) * L::kLdQK + col);
          split(kv.x, b0hi[n][0], b0lo[n][0]);
          split(kv.y, b0hi[n][1], b0lo[n][1]);
          split(kv.z, b1hi[n][0], b1lo[n][0]);
          split(kv.w, b1hi[n][1], b1lo[n][1]);
        }
        mma3<kNt>(sc, 0, a0hi, a0lo, b0hi, b0lo);
        mma3<kNt>(sc, 0, a1hi, a1lo, b1hi, b1lo);
      }

      // scale, soft-cap, mask; online-softmax update of both rows
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int n = 0; n < kNt; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[n][e] * p.scale;
          if (p.has_cap) x = p.cap * tanhf(x / p.cap);
          if (!all && !visible(p, q_start + row + 8 * (e >> 1),
                               k_start + 8 * n + 2 * t + (e & 1))) {
            x = kNegInf;
          }
          sc[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = expf(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int n = 0; n < kNt; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool keep = all || visible(p, q_start + row + 8 * (e >> 1),
                                           k_start + 8 * n + 2 * t + (e & 1));
          const float pr = keep ? expf(sc[n][e] - m[e >> 1]) : 0.f;
          sc[n][e] = pr;
          sum[e >> 1] += pr;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l[r] = l[r] * alpha[r] + sum[r];
      }
#pragma unroll
      for (int n = 0; n < kDt; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }

      // acc += P V over keys 8j..8j+7: k index t is key 2t, t + 4 is
      // 2t + 1, so the accumulator's probabilities are the A fragment
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
        uint32_t ahi[4], alo[4];
        split(sc[j][0], ahi[0], alo[0]);            // (g, key 2t)
        split(sc[j][2], ahi[1], alo[1]);            // (g + 8, key 2t)
        split(sc[j][1], ahi[2], alo[2]);            // (g, key 2t + 1)
        split(sc[j][3], ahi[3], alo[3]);            // (g + 8, key 2t + 1)
        const float* vb = vs + (8 * j + 2 * t) * L::kLdV + g;
#pragma unroll
        for (int n0 = 0; n0 < kDt; n0 += 8) {
          uint32_t bhi[8][2], blo[8][2];
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            split(vb[8 * (n0 + n)], bhi[n][0], blo[n][0]);             // key 2t
            split(vb[L::kLdV + 8 * (n0 + n)], bhi[n][1], blo[n][1]);   // key 2t + 1
          }
          mma3<8>(acc, n0, ahi, alo, bhi, blo);
        }
      }
    }
    stream_sync(stream);                 // this buffer is refilled next
  }

  // Merge the streams' partial softmaxes into stream 0, in stream order,
  // through the K/V buffers once every stream is done with them (every
  // copy into them has landed).
  __syncthreads();
  float* merge = smem + L::kKV;
  if (stream > 0) {
    float* dst = merge + ((stream - 1) * kRowWarps + rw) * 32 * L::kMerge + lane;
    dst[0] = m[0];
    dst[32] = m[1];
    dst[64] = l[0];
    dst[96] = l[1];
#pragma unroll
    for (int n = 0; n < kDt; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[32 * (4 + 4 * n + e)] = acc[n][e];
    }
  }
  __syncthreads();
  if (stream > 0) return;
  for (int s = 1; s < kS; ++s) {
    const float* src = merge + ((s - 1) * kRowWarps + rw) * 32 * L::kMerge + lane;
    float a[2], c[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float ms = src[32 * r];
      const float m_new = fmaxf(m[r], ms);
      a[r] = expf(m[r] - m_new);
      c[r] = expf(ms - m_new);
      l[r] = l[r] * a[r] + src[32 * (2 + r)] * c[r];
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < kDt; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[n][e] = acc[n][e] * a[e >> 1] + src[32 * (4 + 4 * n + e)] * c[e >> 1];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q_start + row + 8 * r;
    if (qi >= p.s) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int n = 0; n < kDt; ++n) {
      *reinterpret_cast<float2*>(o + static_cast<int64_t>(qi) * D + 8 * n + 2 * t) =
          make_float2(acc[n][2 * r] / den, acc[n][2 * r + 1] / den);
    }
  }
}

template <int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Layout<D>::kBytes));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const unsigned blocks = static_cast<unsigned>(p.num_q) *
                          static_cast<unsigned>(p.batch_heads);
  flash_fwd_kernel<D><<<blocks, Layout<D>::kThreads, Layout<D>::kBytes, stream>>>(p);
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
                 has_window, window, has_cap, cap, batch * heads,
                 (s + kBq - 1) / kBq};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (d == 64) {
    err = launch<64>(p, st);
  } else if (d == 128) {
    err = launch<128>(p, st);
  } else if (d == 256) {
    err = launch<256>(p, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // extern "C"
