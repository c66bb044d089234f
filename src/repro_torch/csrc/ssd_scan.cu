// Mamba2 SSD chunked scan for Hopper (sm_90a), chunk-parallel.
//
// Replaces src/repro/kernels/ssd_scan/kernel.py::ssd_scan (_ssd_kernel
// :27-69, pallas_call :86): x (B, L, H, P), dt (B, L, H), a (H,), b, c
// (B, L, N) -> y (B, L, H, P), all f32. Per chunk of Q rows, with
// cum = prefix sum of dt*a over the chunk and xdt = x*dt:
//   y[i]    = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) xdt_j
//           + exp(cum_i) C_i . S_in                  (S_in: the (P, N) state)
//   S_in'   = exp(cum_{Q-1}) S_in + S_c,   S_c = sum_j exp(cum_{Q-1} - cum_j) xdt_j (x) B_j
//
// Bound on an H100: operations. At the mamba2 path's shape (B=1, L=1024,
// H=32, P=64, N=128, Q=128) the function needs C.B^T once per (batch,
// chunk), since every head shares B and C, and per head L.xdt, C.S_in and
// S_c: 1.361 GFLOP over the Q(Q+1)/2 visible pairs, 20.3 us at 67 TFLOP/s
// f32 FMA, against 18 MB of traffic (5.4 us at 3.35 TB/s). The Pallas
// kernel walks the chunks in sequence per (batch, head); here only the
// (P, N) state hand-off is sequential, and it is a streaming pass.
//
// Four phases, three launches, from one entry point (the state-passing
// form of the SSD algorithm, Dao & Gu 2024, section 6):
//   1. cb, per (batch, chunk): G = C.B^T over the 64x64 tiles of the lower
//      triangle, once for every head (the function's C.B^T work, 17 MFLOP
//      at the path), into a (B, L/Q, Qs, Qs) scratch, Qs = Q rounded up to
//      64; and cum for every head (one warp a head: a fixed-order shuffle
//      scan) into a (B, L/Q, H, Q) scratch.
//   2. chunk_state, per (batch, chunk, head, 64x64 tile of (N, P)), for
//      every chunk but the last (whose state nobody reads): S_c^T =
//      B^T.(exp(cum_last - cum) * xdt), a (N x Q).(Q x P) product, into a
//      (B, L/Q - 1, H, N, Pp) scratch, Pp = P rounded up to 4. It forms
//      its chunk's cum itself, so it does not wait for cb: the two share
//      one launch (cb_state_kernel), cb's few blocks first, running beside
//      the chunk states.
//   3. state_pass, per (batch, head) and float4 of the state, sequential
//      over chunks only: S_in[c + 1] = exp(cum_last[c]) S_in[c] + S_c, in
//      place (slot c then holds the state entering chunk c + 1). It moves
//      2 x 7.3 MB at the path, most of it still in L2.
//   4. chunk_scan, per (batch, chunk, head, 64x64 tile of (Q, P)):
//      y = exp(cum_i) C.S_in (a (Q x N).(N x P) product, skipped in chunk
//      0), then + (G o exp(cum_i - cum_j))_{j<=i} . xdt over the j tiles
//      the block's rows reach; a warp whose 16 rows lie above a j tile
//      skips it.
// The chunk states and the chunk scan run 448 and 512 blocks at the path
// (3-4 blocks per SM).
//
// What each phase does about the operations bound: every product is a
// register-tiled f32 FFMA loop. A block of 128 threads owns a 64x64
// output tile; a thread owns 4 rows x 8 columns (32 accumulators) and
// reads its operands from shared memory as float4, 12 floats per 32 FMAs
// (3 LDS.128 per 32 FFMA), laid out so that no load has a bank conflict.
// Operand tiles of 32 along the reduction are staged from device memory
// with cp.async, double-buffered (the next tile's copy is in flight while
// the current one is multiplied); x*dt, the decayed x*dt and the decayed,
// masked G are formed in shared memory once per staged tile. Shared memory
// is static, 38 KB (38,912 bytes) a block at most, so no opt-in attribute
// is needed.
//
// Arithmetic: IEEE f32 FFMA (no TF32, no tensor cores). Every sum runs in a
// fixed order with no atomics, so reruns are bit-identical. The decay
// exponent cum_i - cum_j is formed for j <= i only, so nothing overflows
// at any a (where the TPU kernel takes exp over the whole block and masks
// afterwards). Rows past Q and columns past P or N are zero-filled by the
// copies (the reduction axes) or never stored (the output axes).
//
// x, b and c are read through their batch and row strides (the model hands
// in views of one in_proj/conv output); within a row, x's (H, P) and b's
// and c's N entries are packed. dt, a and y are contiguous. An operand
// whose rows are not 16-byte aligned is copied 4 bytes at a time.
//
// The entry point returns the first launch error (cudaGetLastError()).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;             // four warps; a warp owns 16 rows
constexpr int kTile = 64;                 // output tile edge
constexpr int kTK = 32;                   // reduction depth of a staged tile
constexpr int kLdMinor = kTK + 4;         // [row][k] tiles (64 x 36)
constexpr int kLdMajor = kTile + 4;       // [k][row] tiles (32 x 68)
constexpr int kStage = kTile * kLdMinor;  // floats of one staged operand
constexpr int kMaxQ = 256;                // chunk rows the prefix sum holds
constexpr int kPassThreads = 256;
constexpr int kPassBatch = 16;            // chunks whose loads go out together

enum Launch { kCbState = 1, kPass = 2, kScan = 4 };

__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Copies a tile of kOuter rows of kInner floats into shared memory (row r
// at dst + r * ld): element (r, i) is src[r * stride + i] when r < rows and
// i < cols, else 0. src, the tile's origin, is a valid address. vec: 16-byte
// copies (src 16-byte aligned, stride a multiple of 4, and a group of four
// columns either all below cols or past the row's storage).
template <int kOuter, int kInner>
__device__ __forceinline__ void stage(float* dst, int ld, const float* src,
                                      int64_t stride, int rows, int cols,
                                      bool vec) {
  constexpr int kGroups = kInner / 4;
  for (int e = threadIdx.x; e < kOuter * kGroups; e += kThreads) {
    const int r = e / kGroups;
    const int i = (e % kGroups) * 4;
    float* d = dst + r * ld + i;
    const float* s = src + r * stride + i;
    if (vec) {
      const bool ok = r < rows && i < cols;
      cp16(d, ok ? s : src, ok);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool ok = r < rows && i + k < cols;
        cp4(d + k, ok ? s + k : src, ok);
      }
    }
  }
}

// The thread's place in its block's 64x64 output tile: warp w owns rows
// [16w, 16w + 16); lane = 8 rg + cg.
struct Lane {
  int w, rg, cg;
  __device__ Lane()
      : w(threadIdx.x / 32), rg((threadIdx.x % 32) / 8), cg(threadIdx.x % 8) {}
  // A staged [row][k] (kMinor) reads rows 16w + rg + 4r, one float4 of k
  // each; A staged [k][row] reads rows 16w + 4rg + r as one float4.
  template <bool kMinor>
  __device__ int row(int r) const {
    return kMinor ? 16 * w + rg + 4 * r : 16 * w + 4 * rg + r;
  }
  // B staged [col][k] (kMinor) reads columns cg + 8c; B staged [k][col]
  // reads columns 4cg + c and 32 + 4cg + c as two float4.
  template <bool kMinor>
  __device__ int col(int c) const {
    return kMinor ? cg + 8 * c : (c < 4 ? 4 * cg + c : 28 + 4 * cg + c);
  }
};

// acc[r][c] += sum over the staged k (ascending) of A(row r, k) B(k, col c).
template <bool kAMinor, bool kBMinor>
__device__ __forceinline__ void mma(const float* as, const float* bs,
                                    float (&acc)[4][8], const Lane& ln) {
#pragma unroll
  for (int k0 = 0; k0 < kTK; k0 += 4) {
    float av[4][4];   // [k][r]
    float bv[4][8];   // [k][c]
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if constexpr (kAMinor) {
        const float4 t = *reinterpret_cast<const float4*>(
            as + ln.row<true>(r) * kLdMinor + k0);
        av[0][r] = t.x; av[1][r] = t.y; av[2][r] = t.z; av[3][r] = t.w;
      } else {
        const float4 t = *reinterpret_cast<const float4*>(
            as + (k0 + r) * kLdMajor + ln.row<false>(0));
        av[r][0] = t.x; av[r][1] = t.y; av[r][2] = t.z; av[r][3] = t.w;
      }
    }
    if constexpr (kBMinor) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float4 t = *reinterpret_cast<const float4*>(
            bs + ln.col<true>(c) * kLdMinor + k0);
        bv[0][c] = t.x; bv[1][c] = t.y; bv[2][c] = t.z; bv[3][c] = t.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float* row = bs + (k0 + k) * kLdMajor;
        const float4 t0 = *reinterpret_cast<const float4*>(row + ln.col<false>(0));
        const float4 t1 = *reinterpret_cast<const float4*>(row + ln.col<false>(4));
        bv[k][0] = t0.x; bv[k][1] = t0.y; bv[k][2] = t0.z; bv[k][3] = t0.w;
        bv[k][4] = t1.x; bv[k][5] = t1.y; bv[k][6] = t1.z; bv[k][7] = t1.w;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(av[k][r], bv[k][c], acc[r][c]);
      }
    }
  }
}

// cum[i] = sum_{k<=i} dt[k] a over the chunk's Q rows (dt's row stride H),
// by one warp: lane l sums rows [l seg, (l + 1) seg) in order, then an
// inclusive shuffle scan over the lanes' totals. dt a is rounded before
// the sum (no contraction), so every block that forms a chunk's cum gets
// the same bits.
__device__ void chunk_cum(const float* dtc, int H, float ah, int Q,
                          float* out) {
  const int lane = threadIdx.x % 32;
  const int seg = (Q + 31) / 32;
  float part[kMaxQ / 32];
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxQ / 32; ++k) {
    if (k < seg) {
      const int i = lane * seg + k;
      if (i < Q) run = __fadd_rn(run, __fmul_rn(dtc[static_cast<int64_t>(i) * H], ah));
      part[k] = run;
    }
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl = __fadd_rn(incl, t);
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxQ / 32; ++k) {
    const int i = lane * seg + k;
    if (k < seg && i < Q) out[i] = __fadd_rn(excl, part[k]);
  }
}

// The operands and sizes the launches share.
struct Args {
  const float* x;
  const float* dt;
  const float* a;
  const float* b;
  const float* c;
  float* y;
  float* g;
  float* s;
  float* cum;
  int batch, L, H, P, N, Q;
  int nc, qs, pp, qt, ptiles, ntiles;
  int64_t x_sb, x_sl, b_sb, b_sl, c_sb, c_sl;
  int vec_x, vec_b, vec_c;
};

// One 64x64 tile (ti >= tj, t = ti (ti + 1) / 2 + tj) of chunk ch's
// G = C.B^T: A = C staged [i][n], B = B staged [j][n].
__device__ __forceinline__ void cb_block(const Args& p, int bi, int ch, int t,
                                         float (*sa)[kStage],
                                         float (*sb)[kStage]) {
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
  const int i0 = ti * kTile;
  const int j0 = (t - ti * (ti + 1) / 2) * kTile;
  const int64_t l0 = static_cast<int64_t>(ch) * p.Q;
  const float* cs = p.c + bi * p.c_sb + (l0 + i0) * p.c_sl;
  const float* bs = p.b + bi * p.b_sb + (l0 + j0) * p.b_sl;
  const Lane ln;
  float acc[4][8] = {};
  const int nt = (p.N + kTK - 1) / kTK;
  auto fetch = [&](int k) {
    const int n0 = k * kTK;
    stage<kTile, kTK>(sa[k & 1], kLdMinor, cs + n0, p.c_sl, p.Q - i0, p.N - n0, p.vec_c);
    stage<kTile, kTK>(sb[k & 1], kLdMinor, bs + n0, p.b_sl, p.Q - j0, p.N - n0, p.vec_b);
    cp_commit();
  };
  fetch(0);
  for (int k = 0; k < nt; ++k) {
    if (k + 1 < nt) {
      fetch(k + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    mma<true, true>(sa[k & 1], sb[k & 1], acc, ln);
    __syncthreads();
  }
  float* gt = p.g + ((static_cast<int64_t>(bi) * p.nc + ch) * p.qs + i0) * p.qs + j0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      gt[static_cast<int64_t>(ln.row<true>(r)) * p.qs + ln.col<true>(c)] = acc[r][c];
    }
  }
}

// One 64x64 tile (n0, p0) of chunk ch's own state, transposed:
// S_c^T[n][p] = sum_j B[j][n] w[j][p], w = (x dt) exp(cum_last - cum_j);
// A = B staged [j][n], B = w staged [j][p]. The block forms the chunk's
// cum itself (warp 0, the same bits as the cum blocks write).
__device__ __forceinline__ void state_block(const Args& p, int bi, int h,
                                            int ch, int n0, int p0,
                                            float (*sa)[kStage],
                                            float (*sb)[kStage], float* sdt,
                                            float* sdec) {
  const int64_t l0 = static_cast<int64_t>(ch) * p.Q;
  const float* dtc = p.dt + (static_cast<int64_t>(bi) * p.L + l0) * p.H + h;
  const float* xs = p.x + bi * p.x_sb + l0 * p.x_sl + h * p.P + p0;
  const float* bs = p.b + bi * p.b_sb + l0 * p.b_sl + n0;
  const Lane ln;
  float acc[4][8] = {};
  const int nt = (p.Q + kTK - 1) / kTK;
  auto fetch = [&](int k) {
    const int j0 = k * kTK;
    stage<kTK, kTile>(sa[k & 1], kLdMajor, bs + j0 * p.b_sl, p.b_sl, p.Q - j0, p.N - n0, p.vec_b);
    stage<kTK, kTile>(sb[k & 1], kLdMajor, xs + j0 * p.x_sl, p.x_sl, p.Q - j0, p.P - p0, p.vec_x);
    cp_commit();
  };
  fetch(0);
  if (ln.w == 0) chunk_cum(dtc, p.H, p.a[h], p.Q, sdec);
  for (int j = threadIdx.x; j < kMaxQ; j += kThreads) {
    sdt[j] = j < p.Q ? dtc[static_cast<int64_t>(j) * p.H] : 0.f;
  }
  __syncthreads();
  const float last = sdec[p.Q - 1];
  __syncthreads();
  for (int j = threadIdx.x; j < kMaxQ; j += kThreads) {
    sdec[j] = j < p.Q ? expf(last - sdec[j]) : 0.f;
  }
  for (int k = 0; k < nt; ++k) {
    if (k + 1 < nt) {
      fetch(k + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    float* wt = sb[k & 1];
    for (int e = threadIdx.x; e < kTK * kTile; e += kThreads) {
      const int j = k * kTK + e / kTile;
      float* v = wt + (e / kTile) * kLdMajor + e % kTile;
      *v = (*v * sdt[j]) * sdec[j];
    }
    __syncthreads();
    mma<false, false>(sa[k & 1], wt, acc, ln);
    __syncthreads();
  }
  float* st = p.s + ((static_cast<int64_t>(bi) * (p.nc - 1) + ch) * p.H + h) *
                        p.N * p.pp;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int n = n0 + ln.row<false>(r);
    if (n >= p.N) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = p0 + ln.col<false>(4 * half);
      if (q < p.pp) {
        *reinterpret_cast<float4*>(st + static_cast<int64_t>(n) * p.pp + q) =
            make_float4(acc[r][4 * half], acc[r][4 * half + 1],
                        acc[r][4 * half + 2], acc[r][4 * half + 3]);
      }
    }
  }
}

// 1+2. A 1-D grid: first the (tiles + ceil(H / 4)) x (L / Q) x B blocks of
//      cb (a 64x64 tile of G, or cum for four heads, a warp a head), so
//      that they run beside the chunk states and not after them; then the
//      (B H) x (L / Q - 1) x (ntiles ptiles) blocks of chunk_state.
__global__ void __launch_bounds__(kThreads, 4)
cb_state_kernel(const Args p, int tiles, int64_t cb_blocks) {
  __shared__ __align__(16) float sa[2][kStage];
  __shared__ __align__(16) float sb[2][kStage];
  __shared__ float sdt[kMaxQ];
  __shared__ float sdec[kMaxQ];
  int64_t id = blockIdx.x;
  if (id < cb_blocks) {
    const int per_chunk = tiles + (p.H + 3) / 4;
    const int t = static_cast<int>(id % per_chunk);
    const int ch = static_cast<int>(id / per_chunk % p.nc);
    const int bi = static_cast<int>(id / per_chunk / p.nc);
    if (t < tiles) {
      cb_block(p, bi, ch, t, sa, sb);
    } else {
      const int h = (t - tiles) * 4 + threadIdx.x / 32;
      if (h < p.H) {
        chunk_cum(p.dt + (static_cast<int64_t>(bi) * p.L +
                          static_cast<int64_t>(ch) * p.Q) * p.H + h,
                  p.H, p.a[h], p.Q,
                  p.cum + ((static_cast<int64_t>(bi) * p.nc + ch) * p.H + h) * p.Q);
      }
    }
    return;
  }
  id -= cb_blocks;
  const int64_t bh_count = static_cast<int64_t>(p.batch) * p.H;
  const int bh = static_cast<int>(id % bh_count);
  const int ch = static_cast<int>(id / bh_count % (p.nc - 1));
  const int tz = static_cast<int>(id / bh_count / (p.nc - 1));
  state_block(p, bh / p.H, bh % p.H, ch, (tz / p.ptiles) * kTile,
              (tz % p.ptiles) * kTile, sa, sb, sdt, sdec);
}

// 3. Grid (B H, ceil(N Pp / 4 / kPassThreads)). Slot c of s holds S_c on
//    entry and the state entering chunk c + 1 on exit; slot 0 is both.
__global__ void __launch_bounds__(kPassThreads)
pass_kernel(float* __restrict__ s, const float* __restrict__ cum, int H,
            int Q, int nc, int64_t entries) {
  const int bi = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int64_t e =
      (static_cast<int64_t>(blockIdx.y) * kPassThreads + threadIdx.x) * 4;
  if (e >= entries) return;
  const int slots = nc - 1;
  const int64_t step = static_cast<int64_t>(H) * entries;
  float* base = s + (static_cast<int64_t>(bi) * slots * H + h) * entries + e;
  const float* last = cum + (static_cast<int64_t>(bi) * nc * H + h) * Q + Q - 1;
  float4 run = *reinterpret_cast<const float4*>(base);
  for (int c0 = 1; c0 < slots; c0 += kPassBatch) {
    float4 v[kPassBatch];
    float gv[kPassBatch];
#pragma unroll
    for (int k = 0; k < kPassBatch; ++k) {
      if (c0 + k < slots) {
        v[k] = *reinterpret_cast<const float4*>(base + (c0 + k) * step);
        gv[k] = expf(last[static_cast<int64_t>(c0 + k) * H * Q]);
      }
    }
#pragma unroll
    for (int k = 0; k < kPassBatch; ++k) {
      if (c0 + k < slots) {
        run.x = __fadd_rn(__fmul_rn(gv[k], run.x), v[k].x);
        run.y = __fadd_rn(__fmul_rn(gv[k], run.y), v[k].y);
        run.z = __fadd_rn(__fmul_rn(gv[k], run.z), v[k].z);
        run.w = __fadd_rn(__fmul_rn(gv[k], run.w), v[k].w);
        *reinterpret_cast<float4*>(base + (c0 + k) * step) = run;
      }
    }
  }
}

// 4. Grid (B H, L / Q, qt ptiles). y[i][p] = exp(cum_i) sum_n C[i][n]
//    S_in^T[n][p] + sum_{j<=i} G[i][j] exp(cum_i - cum_j) xdt[j][p]. The
//    heaviest blocks go out first: the last row tiles (the most j tiles)
//    and the last chunks (chunk 0 has no entering state).
__global__ void __launch_bounds__(kThreads, 4)
scan_kernel(const Args p) {
  __shared__ __align__(16) float sa[2][kStage];
  __shared__ __align__(16) float sb[2][kStage];
  __shared__ float scum[kMaxQ];
  __shared__ float sdt[kMaxQ];
  const int bi = blockIdx.x / p.H;
  const int h = blockIdx.x % p.H;
  const int ch = p.nc - 1 - blockIdx.y;
  const int i0 = (p.qt - 1 - blockIdx.z / p.ptiles) * kTile;
  const int p0 = (blockIdx.z % p.ptiles) * kTile;
  const int Q = p.Q;
  const int64_t l0 = static_cast<int64_t>(ch) * Q;
  const float* cm = p.cum + ((static_cast<int64_t>(bi) * p.nc + ch) * p.H + h) * Q;
  const float* dtc = p.dt + (static_cast<int64_t>(bi) * p.L + l0) * p.H + h;
  for (int j = threadIdx.x; j < kMaxQ; j += kThreads) {
    scum[j] = j < Q ? cm[j] : 0.f;
    sdt[j] = j < Q ? dtc[static_cast<int64_t>(j) * p.H] : 0.f;
  }
  const float* cs = p.c + bi * p.c_sb + (l0 + i0) * p.c_sl;
  // the state entering this chunk (slot ch - 1; none in chunk 0)
  const float* sprev =
      ch > 0 ? p.s + ((static_cast<int64_t>(bi) * (p.nc - 1) + ch - 1) * p.H + h) *
                         p.N * p.pp + p0
             : p.s;
  const float* gs = p.g + ((static_cast<int64_t>(bi) * p.nc + ch) * p.qs + i0) * p.qs;
  const float* xs = p.x + bi * p.x_sb + l0 * p.x_sl + h * p.P + p0;
  const Lane ln;
  float acc[4][8] = {};
  const int toff = ch > 0 ? (p.N + kTK - 1) / kTK : 0;
  const int nt = toff + (min(i0 + kTile, Q) + kTK - 1) / kTK;
  const int wlast = i0 + 16 * ln.w + 15;      // the warp's last row
  auto fetch = [&](int t) {
    if (t < toff) {
      const int n0 = t * kTK;
      stage<kTile, kTK>(sa[t & 1], kLdMinor, cs + n0, p.c_sl, Q - i0, p.N - n0, p.vec_c);
      stage<kTK, kTile>(sb[t & 1], kLdMajor, sprev + static_cast<int64_t>(n0) * p.pp,
                        p.pp, p.N - n0, p.pp - p0, true);
    } else {
      const int j0 = (t - toff) * kTK;
      stage<kTile, kTK>(sa[t & 1], kLdMinor, gs + j0, p.qs, kTile, kTK, true);
      stage<kTK, kTile>(sb[t & 1], kLdMajor, xs + j0 * p.x_sl, p.x_sl, Q - j0, p.P - p0,
                        p.vec_x);
    }
    cp_commit();
  };
  fetch(0);
  for (int t = 0; t < nt; ++t) {
    if (t + 1 < nt) {
      fetch(t + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int j0 = (t - toff) * kTK;
    if (t >= toff) {
      // G o exp(cum_i - cum_j) for j <= i < Q, else 0; x*dt
      float* gt = sa[t & 1];
      for (int e = threadIdx.x; e < kTile * kTK; e += kThreads) {
        const int i = i0 + e / kTK;
        const int j = j0 + e % kTK;
        float* v = gt + (e / kTK) * kLdMinor + e % kTK;
        *v = (j <= i && i < Q) ? *v * expf(scum[i] - scum[j]) : 0.f;
      }
      float* xt = sb[t & 1];
      for (int e = threadIdx.x; e < kTK * kTile; e += kThreads) {
        float* v = xt + (e / kTile) * kLdMajor + e % kTile;
        *v = *v * sdt[j0 + e / kTile];
      }
      __syncthreads();
      if (t == toff && toff > 0) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float e = expf(scum[i0 + ln.row<true>(r)]);
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] *= e;
        }
      }
      if (j0 <= wlast) mma<true, false>(sa[t & 1], sb[t & 1], acc, ln);
    } else {
      mma<true, false>(sa[t & 1], sb[t & 1], acc, ln);
    }
    __syncthreads();
  }
  const int64_t yrow = static_cast<int64_t>(p.H) * p.P;
  float* yt = p.y + (static_cast<int64_t>(bi) * p.L + l0) * yrow + h * p.P;
  const bool vec_y = p.P % 4 == 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ln.row<true>(r);
    if (i >= Q) continue;
    float* row = yt + i * yrow;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = p0 + ln.col<false>(4 * half);
      const float* v = acc[r] + 4 * half;
      if (vec_y) {
        if (q < p.P) {
          *reinterpret_cast<float4*>(row + q) = make_float4(v[0], v[1], v[2], v[3]);
        }
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (q + k < p.P) row[q + k] = v[k];
        }
      }
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// g: (batch, L/Q, qs, qs), qs = Q rounded up to 64; s: (batch, L/Q - 1, H,
// N, pp), pp = P rounded up to 4 (unused when L = Q); cum: (batch, L/Q, H,
// Q). phases: a mask of the three launches, 1 (cb and the chunk states),
// 2 (state pass), 4 (chunk scan), made in that order; each reads what the
// earlier ones wrote.
int ssd_scan_launch(const float* x, const float* dt, const float* a,
                    const float* b, const float* c, float* y, float* g,
                    float* s, float* cum, int batch, int L, int H, int P,
                    int N, int Q, int64_t x_sb, int64_t x_sl, int64_t b_sb,
                    int64_t b_sl, int64_t c_sb, int64_t c_sl, int phases,
                    void* stream) {
  if (Q <= 0 || Q > kMaxQ || batch <= 0 || H <= 0 || P <= 0 || N <= 0 ||
      L <= 0 || L % Q) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args p{x, dt, a, b, c, y, g, s, cum, batch, L, H, P, N, Q};
  p.nc = L / Q;
  p.qs = (Q + kTile - 1) / kTile * kTile;
  p.pp = (P + 3) / 4 * 4;
  p.qt = p.qs / kTile;
  p.ptiles = (p.pp + kTile - 1) / kTile;
  p.ntiles = (N + kTile - 1) / kTile;
  p.x_sb = x_sb; p.x_sl = x_sl;
  p.b_sb = b_sb; p.b_sl = b_sl;
  p.c_sb = c_sb; p.c_sl = c_sl;
  p.vec_x = P % 4 == 0 && x_sb % 4 == 0 && x_sl % 4 == 0 && aligned16(x);
  p.vec_b = N % 4 == 0 && b_sb % 4 == 0 && b_sl % 4 == 0 && aligned16(b);
  p.vec_c = N % 4 == 0 && c_sb % 4 == 0 && c_sl % 4 == 0 && aligned16(c);
  if (phases & kCbState) {
    const int tiles = p.qt * (p.qt + 1) / 2;
    const int64_t cb_blocks =
        static_cast<int64_t>(tiles + (H + 3) / 4) * p.nc * batch;
    const int64_t state_blocks = static_cast<int64_t>(batch) * H *
                                 (p.nc - 1) * p.ntiles * p.ptiles;
    cb_state_kernel<<<static_cast<unsigned>(cb_blocks + state_blocks),
                      kThreads, 0, st>>>(p, tiles, cb_blocks);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if ((phases & kPass) && p.nc > 2) {
    const int64_t entries = static_cast<int64_t>(N) * p.pp;
    const dim3 grid(static_cast<unsigned>(batch * H),
                    static_cast<unsigned>((entries / 4 + kPassThreads - 1) /
                                          kPassThreads));
    pass_kernel<<<grid, kPassThreads, 0, st>>>(s, cum, H, Q, p.nc, entries);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (phases & kScan) {
    const dim3 grid(static_cast<unsigned>(batch * H),
                    static_cast<unsigned>(p.nc),
                    static_cast<unsigned>(p.qt * p.ptiles));
    scan_kernel<<<grid, kThreads, 0, st>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

}  // extern "C"
