// Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces src/repro/kernels/ssd_scan/kernel.py::ssd_scan (_ssd_kernel
// :27-69, pallas_call :86): x (B, L, H, P), dt (B, L, H), a (H,), b, c
// (B, L, N) -> y (B, L, H, P), all f32. Per chunk of Q rows, with
// cum = prefix sum of dt*a over the chunk and xdt = x*dt:
//   y[i]  = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) xdt_j
//         + exp(cum_i) C_i . S                       (S: the (P, N) state)
//   S    <- exp(cum_{Q-1}) S + sum_j exp(cum_{Q-1} - cum_j) xdt_j (x) B_j
//
// Bound on an H100: operations. At the mamba2 path's shape (B=1, L=1024,
// H=32, P=64, N=128, Q=128) the function needs C.B^T once per (batch,
// chunk), since every head shares B and C, and L.xdt, C.S and the state
// update per head: 1.36 GFLOP over the Q(Q+1)/2 visible pairs, 20 us at
// 67 TFLOP/s f32 FMA, against 18 MB of traffic (5.4 us at 3.35 TB/s).
//
// x, b and c are read through their batch and row strides (the model
// hands in views of one in_proj/conv output); within a row, x's (H, P) and
// b's and c's N entries are packed. dt, a and y are contiguous.
//
// Design. The Pallas grid's sequential chunk axis becomes a loop inside
// the block. Column p of a head's output depends only on column p of x and
// row p of S, so a block owns one (batch, head) and a tile of kPT = 16 of
// its P columns, with that tile of S carried in shared memory across the
// chunk loop: B*H*P/16 = 128 blocks at the path's shape fill the card in
// one wave (at 220 KB of shared memory a block has its SM to itself), and
// C.B^T, which every tile needs, is recomputed per tile (4x at P=64). Per
// chunk the block stages B and C transposed ([n][row], so a 4-wide row
// group is one float4), x*dt and the prefix sums in shared memory; builds
// the masked, decayed score matrix L from 4x4 register tiles of the lower
// triangle only (the exponent is formed for j <= i alone, so nothing
// overflows where the TPU kernel takes exp over the whole block and masks
// afterwards); then each thread forms 4 outputs y[i][p] from L, x*dt, C and
// S; then 4 entries of the new S. 512 threads a block: 16 warps hide the
// shared-memory latency of the one block an SM holds. All products are IEEE f32 FMAs (no TF32,
// no tensor cores); every sum runs in a fixed order with no atomics, so
// reruns are bit-identical. Rows past Q in the padded chunk are zero and
// columns past P are skipped.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kPT = 16;              // head columns per block
constexpr int kMaxQ = 256;           // padded chunk rows a block can stage
constexpr int kRowStride = kThreads / kPT;   // rows between a thread's rows

__host__ __device__ inline int padded(int q) { return (q + 31) / 32 * 32; }

// Shared floats: C^T and B^T (N x ldq each), L (Qp x ldq), x*dt (Qp x kPT),
// S^T (N x kPT), and cum, exp(cum), exp(cum_last - cum) (Qp each).
__host__ __device__ inline size_t smem_floats(int qp, int n) {
  const size_t ldq = qp + 4;
  return 2 * n * ldq + qp * ldq + static_cast<size_t>(qp) * kPT +
         static_cast<size_t>(n) * kPT + 3 * static_cast<size_t>(qp);
}

__global__ void __launch_bounds__(kThreads)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a, const float* __restrict__ b,
           const float* __restrict__ c, float* __restrict__ y, int L, int H,
           int P, int N, int Q, int64_t x_sb, int64_t x_sl, int64_t b_sb,
           int64_t b_sl, int64_t c_sb, int64_t c_sl) {
  extern __shared__ __align__(16) float smem[];
  const int qp = padded(Q);
  const int ldq = qp + 4;
  float* ct = smem;                  // [n][i]
  float* bt = ct + N * ldq;          // [n][j]
  float* lm = bt + N * ldq;          // [i][j], j <= i < Q written
  float* xd = lm + qp * ldq;         // [j][pp]
  float* st = xd + qp * kPT;         // [n][pp]
  float* cum = st + N * kPT;
  float* ecum = cum + qp;
  float* dec = ecum + qp;

  const int tid = threadIdx.x;
  const int bi = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int p0 = blockIdx.y * kPT;
  const float ah = a[h];
  const int64_t yrow = static_cast<int64_t>(H) * P;   // y: stride of l
  const float* xb = x + bi * x_sb + h * P + p0;
  float* yb = y + static_cast<int64_t>(bi) * L * yrow + h * P + p0;
  const float* dtb = dt + static_cast<int64_t>(bi) * L * H + h;
  const float* bb = b + bi * b_sb;
  const float* cb = c + bi * c_sb;
  const int pp = tid % kPT;
  const int r0 = tid / kPT;
  const bool col_ok = p0 + pp < P;
  const int groups = qp / 4;
  const int tiles = groups * (groups + 1) / 2;

  for (int e = tid; e < N * kPT; e += kThreads) st[e] = 0.f;

  for (int l0 = 0; l0 < L; l0 += Q) {
    __syncthreads();                 // the previous chunk is done with smem

    // 1. cum = prefix sum of dt*a over the chunk (warp 0: each lane sums
    //    qp/32 consecutive rows, then a shuffle scan over the lanes).
    if (tid < 32) {
      const int seg = qp / 32;
      float part[kMaxQ / 32];
      float run = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxQ / 32; ++k) {
        if (k < seg) {
          const int i = tid * seg + k;
          run += i < Q ? dtb[static_cast<int64_t>(l0 + i) * H] * ah : 0.f;
          part[k] = run;
        }
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += t;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxQ / 32; ++k) {
        if (k < seg) cum[tid * seg + k] = excl + part[k];
      }
    }
    // 2. Stage x*dt (this block's columns), B^T and C^T; padded rows are 0.
    for (int e = tid; e < qp * kPT; e += kThreads) {
      const int j = e / kPT;
      const int q = e % kPT;
      float v = 0.f;
      if (j < Q && p0 + q < P) {
        const int64_t l = l0 + j;
        v = xb[l * x_sl + q] * dtb[l * H];
      }
      xd[e] = v;
    }
    for (int e = tid; e < qp * N; e += kThreads) {
      const int j = e / N;
      const int n = e % N;
      float bv = 0.f, cv = 0.f;
      if (j < Q) {
        const int64_t l = l0 + j;
        bv = bb[l * b_sl + n];
        cv = cb[l * c_sl + n];
      }
      bt[n * ldq + j] = bv;
      ct[n * ldq + j] = cv;
    }
    __syncthreads();
    const float clast = cum[Q - 1];
    for (int i = tid; i < qp; i += kThreads) {
      ecum[i] = expf(cum[i]);
      dec[i] = expf(clast - cum[i]);
    }

    // 3. L[i][j] = (C_i . B_j) exp(cum_i - cum_j) over the 4x4 tiles of
    //    the lower triangle; within a diagonal tile j > i is 0, and rows or
    //    columns past Q are 0.
    for (int t = tid; t < tiles; t += kThreads) {
      int ri = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
      while ((ri + 1) * (ri + 2) / 2 <= t) ++ri;
      while (ri * (ri + 1) / 2 > t) --ri;
      const int cj = t - ri * (ri + 1) / 2;
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[r][s] = 0.f;
      }
      for (int n = 0; n < N; ++n) {
        const float4 cv = *reinterpret_cast<const float4*>(ct + n * ldq + 4 * ri);
        const float4 bv = *reinterpret_cast<const float4*>(bt + n * ldq + 4 * cj);
        const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
        const float bs[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(cr[r], bs[s], acc[r][s]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * ri + r;
        float out[4];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int j = 4 * cj + s;
          out[s] = (j <= i && i < Q) ? acc[r][s] * expf(cum[i] - cum[j]) : 0.f;
        }
        *reinterpret_cast<float4*>(lm + i * ldq + 4 * cj) =
            make_float4(out[0], out[1], out[2], out[3]);
      }
    }
    __syncthreads();

    // 4. y[i][pp] = sum_{j<=i} L[i][j] xdt[j][pp] + exp(cum_i) C_i . S[pp]
    //    for rows i = r0, r0 + 32, ...; four rows at a time.
    for (int i0 = r0; i0 < Q; i0 += 4 * kRowStride) {
      int rows[4];
      float off[4], diag[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        rows[k] = min(i0 + k * kRowStride, Q - 1);
        off[k] = 0.f;
        diag[k] = 0.f;
      }
      for (int n = 0; n < N; ++n) {
        const float s = st[n * kPT + pp];
#pragma unroll
        for (int k = 0; k < 4; ++k) off[k] = fmaf(ct[n * ldq + rows[k]], s, off[k]);
      }
      const int last = rows[3];
      for (int j = 0; j <= last; ++j) {
        const float v = xd[j * kPT + pp];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (j <= rows[k]) diag[k] = fmaf(lm[rows[k] * ldq + j], v, diag[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = i0 + k * kRowStride;
        if (i < Q && col_ok) {
          yb[static_cast<int64_t>(l0 + i) * yrow + pp] =
              diag[k] + ecum[i] * off[k];
        }
      }
    }
    __syncthreads();

    // 5. S[pp][n] <- exp(cum_last) S[pp][n]
    //               + sum_j exp(cum_last - cum_j) xdt[j][pp] B[j][n]
    //    for n = r0, r0 + 32, ...; four at a time.
    const float g = ecum[Q - 1];
    for (int n0 = r0; n0 < N; n0 += 4 * kRowStride) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      int ns[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) ns[k] = min(n0 + k * kRowStride, N - 1);
      for (int j = 0; j < Q; ++j) {
        const float w = dec[j] * xd[j * kPT + pp];
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] = fmaf(w, bt[ns[k] * ldq + j], acc[k]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int n = n0 + k * kRowStride;
        if (n < N) st[n * kPT + pp] = g * st[n * kPT + pp] + acc[k];
      }
    }
  }
}

// Bytes of dynamic shared memory a launch needs (0 when Q is out of range).
size_t smem_bytes(int q, int n) {
  if (q <= 0 || padded(q) > kMaxQ || n <= 0) return 0;
  return smem_floats(padded(q), n) * sizeof(float);
}

}  // namespace

extern "C" {

int ssd_scan_launch(const float* x, const float* dt, const float* a,
                    const float* b, const float* c, float* y, int batch,
                    int L, int H, int P, int N, int Q, int64_t x_sb,
                    int64_t x_sl, int64_t b_sb, int64_t b_sl, int64_t c_sb,
                    int64_t c_sl, void* stream) {
  const size_t bytes = smem_bytes(Q, N);
  if (bytes == 0 || batch <= 0 || H <= 0 || P <= 0 || L <= 0 || L % Q) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Once per process: the card's opt-in shared memory per block, granted
  // to the kernel (above 48 KB a launch is refused without it). Done before
  // the first launch, so a launch captured into a CUDA graph later makes
  // no attribute call.
  static int optin = 0;
  if (optin == 0) {
    int dev = 0, limit = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(
          &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    }
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    optin = limit;
  }
  if (bytes > static_cast<size_t>(optin)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(batch * H),
                  static_cast<unsigned>((P + kPT - 1) / kPT));
  ssd_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      x, dt, a, b, c, y, L, H, P, N, Q, x_sb, x_sl, b_sb, b_sl, c_sb, c_sl);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
