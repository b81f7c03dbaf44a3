// ssd_scan for Hopper (sm_90a): the chunked Mamba2/SSD scan, prefill only.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssm_scan/kernel.py
// (_ssd_kernel / ssd_scan_pallas). Per batch row b and head h, over chunks
// of Q time steps, with cum the running sum of dt * A_h inside the chunk:
//
//   y_intra[i] = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//   y_inter[i] = exp(cum_i) C_i . S
//   S         <- exp(cum_last) S + sum_j exp(cum_last - cum_j) dt_j x_j B_j^T
//
// and y = y_intra + y_inter. The [P, N] state S starts at zero and is not
// returned (the TPU kernel's scratch, kernel.py:113).
//
// Shapes: x [B, S, H, P], dt [B, S, H], A [H], B and C [B, S, N], all f32,
// read in place through their strides (no moveaxis, reshape or pad copies:
// those were a TPU layout need); y is a new contiguous [B, S, H, P]. B and C
// are shared across heads: the block of (b, h) reads batch row b's.
//
// What bounds it: at zamba2's prefill (x [2, 4096, 80, 64], Q = 64,
// N = 64) the four products of a chunk are ~1M fp32 multiply-adds a head,
// against 16 KB of x read and 16 KB of y written, so the work on the CUDA
// cores in fp32 bounds it, not the bytes.
//
// Design (simple and right first):
// - One block of 256 threads per (b, h); the block walks its chunks in
//   order, which takes the place of the TPU's sequential grid axis. The
//   state stays in registers, a 4 x 4 tile of (n, p) a thread, and is
//   written to shared memory once per chunk for the next chunk's y_inter.
// - Every operand lives in shared memory as a 64 x 64 fp32 tile at a pitch
//   of 68 floats: C and B transposed (n, i), B row-major (j, n), dt * x
//   (j, p), the masked C B^T ⊙ L transposed (j, i), and the state (n, p).
//   Rows past the sequence's end (the ragged last chunk) and columns past
//   P or N are stored as zeros, so no input is padded in memory and they
//   add nothing. Each product is a 64 x 64 output, a 4 x 4 register tile a
//   thread, fed by two float4 reads of shared memory per step.
// - One thread sums cum in order, cum_i = cum_{i-1} + dt_i A_h. At
//   zamba2's A = -(1 .. 80) cum reaches about -3,500 within a chunk, and
//   exp(cum_i - cum_j) is a difference of two large sums: in order,
//   neighbours differ by one rounding (an ulp of 3,500 is 2.4e-4), while a
//   parallel scan builds them from different partial sums; on an H100 at
//   zamba2's prefill shape a warp scan put the kernel 3.5x farther from an
//   f64 oracle than the plain version.
// - exp(cum_i) and exp(cum_last - cum_j) are taken once per time step, and
//   exp(cum_i - cum_j) only for j <= i: the upper triangle would be
//   exp(+large) = inf, and inf * 0 is NaN. Tiles wholly above the diagonal
//   are skipped, and y_intra's loop stops at the tile's last row.
// - Arithmetic is fp32 throughout, as in the Pallas kernel, with expf (the
//   build has no fast math). Shared memory is 105,216 bytes, so two blocks
//   fit an SM.
// - Not in this version: C B^T computed once per (b, chunk) for all heads,
//   the tensor cores, and a form parallel over chunks.
// - The launch allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int T = 64;            // the largest chunk, P and N: the tile edge
constexpr int LD = T + 4;        // pitch of every tile
constexpr int kSmemFloats = 6 * T * LD + 3 * T;

struct Args {
  const float* x;
  const float* dt;
  const float* A;
  const float* bm;
  const float* cm;
  float* y;
  int S, H, P, N, Q;
  int64_t xs[4];   // strides of x (b, s, h, p), in elements
  int64_t ds[3];   // dt (b, s, h)
  int64_t bs[3];   // B (b, s, n)
  int64_t cs[3];   // C (b, s, n)
};

__device__ __forceinline__ void fma_tile(float (&acc)[4][4], float4 a4,
                                         float4 b4) {
  const float a[4] = {a4.x, a4.y, a4.z, a4.w};
  const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__global__ void __launch_bounds__(kThreads, 2) ssd_scan_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* Ct = reinterpret_cast<float*>(smem4);  // [n][i] C of the chunk
  float* Bt = Ct + T * LD;                      // [n][j] B
  float* Br = Bt + T * LD;                      // [j][n] B
  float* X = Br + T * LD;                       // [j][p] dt * x
  float* Mt = X + T * LD;                       // [j][i] (C B^T ⊙ L)
  float* St = Mt + T * LD;                      // [n][p] state before the chunk
  float* cum = St + T * LD;                     // [i] running sum of dt * A
  float* eC = cum + T;                          // exp(cum_i)
  float* dec = eC + T;                          // exp(cum_last - cum_j)

  const int b = (int)blockIdx.x / a.H, h = (int)blockIdx.x % a.H;
  const int tid = threadIdx.x;
  const int r0 = (tid / 16) * 4, c0 = (tid % 16) * 4;   // the thread's tile
  const int Q = a.Q, N = a.N, P = a.P;
  const float Ah = a.A[h];
  const float* xb = a.x + b * a.xs[0] + h * a.xs[2];
  const float* db = a.dt + b * a.ds[0] + h * a.ds[2];
  const float* Bb = a.bm + b * a.bs[0];
  const float* Cb = a.cm + b * a.cs[0];
  const int64_t y_row = (int64_t)a.H * P;
  float* yb = a.y + ((int64_t)b * a.S * a.H + h) * P;

  float st[4][4];   // state (n = r0 + r, p = c0 + c)
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) st[r][c] = 0.f;
  for (int e = tid; e < T * LD; e += kThreads) St[e] = 0.f;

  const int nc = (a.S + Q - 1) / Q;
  for (int ch = 0; ch < nc; ++ch) {
    const int s0 = ch * Q;
    const int qv = min(Q, a.S - s0);   // rows of this chunk in the sequence

    // (1) cum, exp(cum) and the decay to the chunk's end (warp 0), and the
    // tiles of the chunk; rows at or past qv read as 0, as the reference's
    // zero padding gives them (dt = 0, so cum stays flat there)
    if (tid < 32) {
      for (int i = tid; i < T; i += 32)
        cum[i] = i < qv ? db[(int64_t)(s0 + i) * a.ds[1]] * Ah : 0.f;
      __syncwarp();
      if (tid == 0) {   // in order: see the note at the top
        float c = 0.f;
#pragma unroll 16
        for (int i = 0; i < T; ++i) {
          c += cum[i];
          cum[i] = c;
        }
      }
      __syncwarp();
      const float last = cum[Q - 1];
      for (int i = tid; i < T; i += 32) {
        eC[i] = expf(cum[i]);
        dec[i] = expf(last - cum[i]);
      }
    }
    for (int e = tid; e < T * T; e += kThreads) {
      const int r = e / T, k = e % T;   // time row r of the chunk, column k
      const int64_t t = s0 + r;
      const bool row = r < qv;
      const float bv = row && k < N ? Bb[t * a.bs[1] + k * a.bs[2]] : 0.f;
      const float cv = row && k < N ? Cb[t * a.cs[1] + k * a.cs[2]] : 0.f;
      Br[r * LD + k] = bv;
      Bt[k * LD + r] = bv;
      Ct[k * LD + r] = cv;
      X[r * LD + k] = row && k < P
                          ? db[t * a.ds[1]] * xb[t * a.xs[1] + k * a.xs[3]]
                          : 0.f;
    }
    __syncthreads();

    // (2) Mt[j][i] = (C_i . B_j) exp(cum_i - cum_j) for j <= i, else 0
    {
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
      if (c0 <= r0 + 3) {
#pragma unroll 4
        for (int k = 0; k < N; ++k)
          fma_tile(acc, ld4(Ct + k * LD + r0), ld4(Bt + k * LD + c0));
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = c0 + c;
        float m[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = r0 + r;
          m[r] = j <= i ? acc[r][c] * expf(cum[i] - cum[j]) : 0.f;
        }
        *reinterpret_cast<float4*>(Mt + j * LD + r0) =
            make_float4(m[0], m[1], m[2], m[3]);
      }
    }
    __syncthreads();

    // (3) y = exp(cum_i) (C_i . S) + sum_{j <= i} Mt[j][i] (dt x)_j
    {
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 4
      for (int k = 0; k < N; ++k)
        fma_tile(acc, ld4(Ct + k * LD + r0), ld4(St + k * LD + c0));
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float e = eC[r0 + r];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] *= e;
      }
      const int jmax = min(Q, r0 + 4);
#pragma unroll 4
      for (int j = 0; j < jmax; ++j)
        fma_tile(acc, ld4(Mt + j * LD + r0), ld4(X + j * LD + c0));
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = r0 + r;
        if (i >= qv) continue;
        float* yr = yb + (int64_t)(s0 + i) * y_row;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (c0 + c < P) yr[c0 + c] = acc[r][c];
      }
    }

    // (4) S <- exp(cum_last) S + sum_j B_j ⊗ exp(cum_last - cum_j) (dt x)_j
    {
      float upd[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) upd[r][c] = 0.f;
#pragma unroll 4
      for (int j = 0; j < Q; ++j) {
        const float d = dec[j];
        float4 x4 = ld4(X + j * LD + c0);
        x4 = make_float4(d * x4.x, d * x4.y, d * x4.z, d * x4.w);
        fma_tile(upd, ld4(Br + j * LD + r0), x4);
      }
      const float decay = expf(cum[Q - 1]);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) st[r][c] = st[r][c] * decay + upd[r][c];
    }
    __syncthreads();   // every read of St, and of this chunk's tiles, is done
#pragma unroll
    for (int r = 0; r < 4; ++r)
      *reinterpret_cast<float4*>(St + (r0 + r) * LD + c0) =
          make_float4(st[r][0], st[r][1], st[r][2], st[r][3]);
  }
}

}  // namespace

// strides: x (b, s, h, p), dt (b, s, h), B (b, s, n), C (b, s, n), in
// elements; y is written contiguous [B, S, H, P]
extern "C" int ssd_scan_f32(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, void* y, int B,
                            int S, int H, int P, int N, int chunk,
                            const long long* strides, void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || P > T || N < 1 || N > T ||
      chunk < 1 || chunk > T || (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = static_cast<const float*>(x);
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.bm = static_cast<const float*>(Bm);
  a.cm = static_cast<const float*>(Cm);
  a.y = static_cast<float*>(y);
  a.S = S;
  a.H = H;
  a.P = P;
  a.N = N;
  a.Q = chunk;
  for (int i = 0; i < 4; ++i) a.xs[i] = strides[i];
  for (int i = 0; i < 3; ++i) {
    a.ds[i] = strides[4 + i];
    a.bs[i] = strides[7 + i];
    a.cs[i] = strides[10 + i];
  }
  const int bytes = kSmemFloats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<<<(unsigned)(B * H), kThreads, bytes,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
