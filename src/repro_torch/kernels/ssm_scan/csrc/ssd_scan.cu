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
// read in place through their strides; y is a new contiguous [B, S, H, P].
// B and C are shared across heads. A may also be [B, H], one A per batch
// row (a_rs apart): a vmapped population of models folds its
// lanes into B, each lane with its own A; a row's bits are those of a call
// with its A alone.
//
// What bounds it: at zamba2's prefill (x [2, 4096, 80, 64], Q = 64,
// N = 64) the chunked form is 13.4 GFLOP of fp32 multiply-adds (0.20 ms at
// 67 TFLOP/s) against ~0.1 ms of bytes, but each (b, h) walks its 64 chunks
// in order, so the kernel is latency-bound unless enough walks run at once
// and each chunk's loads overlap the previous chunk's work.
//
// Design: two kernels a call.
// - ssd_prep_kernel, one block per (b, chunk), does what every head shares
//   or what is serial: G = C B^T (each entry the fmaf chain over n in
//   order) stored transposed with zeros where i < j, C transposed and B
//   as they are, zero past the sequence and past N, into `tiles`
//   [B, n_chunks, 3, 64, 64]; and per head, by one thread from registers in
//   order, cum_i = cum_{i-1} + dt_i A_h (the same roundings as the previous
//   kernel: at zamba2's A = -(1 .. 80) cum reaches about -3,500 within a
//   chunk, where a parallel scan put a kernel 3.5x farther from an f64
//   oracle), exp(cum_i), exp(cum_last - cum_i) and dt itself, into `vecs`
//   [B, n_chunks, H, 4, 64]. Both are scratch the wrapper allocates (17 MB
//   at zamba2's shape, read from L2).
// - ssd_scan_kernel, one block per (b, h, slice of kPW = 32 state columns):
//   the columns of S are independent (y[:, p] needs only S[:, p] and
//   x[:, p]), so P = 64 in two slices gives 320 walks, three blocks an SM.
//   On an H100 at zamba2's shape slices of 16 and 64 columns ran slower
//   (1.3676 and 0.8917 ms against 0.8073: 640 blocks do not all fit at
//   once, and 160 leave SMs with one block; PERF.md).
//   A thread keeps a 4 x 4 tile of (n, p) of the state in registers and
//   computes a 4 x 4 tile of (i, p) of y. Each chunk's G, C and B arrive by
//   16-byte cp.async from the scratch while the previous phase computes (C
//   and G after the previous chunk's y, B after its state update, x and the
//   vectors a whole chunk ahead); x takes 16-byte copies where its rows are
//   16-byte aligned, else 4-byte ones. Three __syncthreads a chunk. Every
//   product reads one row of a tile per step across the warp, so there are
//   no bank conflicts without padding.
// - Same bits as the previous kernel: every output keeps its sums in the
//   same order (fmaf over n, the product by exp(cum_i), then fmaf over j up
//   to the end of the row's group of 4; the state's fmaf over j of
//   B_j (dec_j x_j), then st * decay + upd), and no product is contracted
//   into an add that was not before.
// - fp32 FFMA, no tensor cores: TF32 keeps about 3 digits, and the f64
//   oracle check at cum ~ -3,500 is an fp32 check; a 3xTF32 mma route is
//   later work.
// - exp(cum_i - cum_j) is taken only for j <= i: the upper triangle would be
//   exp(+large) = inf, and inf * 0 is NaN. Arithmetic is fp32 throughout
//   with expf (the build has no fast math).
// - The launches allocate nothing; the entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 64;              // the largest chunk, P and N
constexpr int kTile = T * T;
constexpr int kPrepThreads = 256;
constexpr int kPW = 32;            // state columns a scan block takes
constexpr int kCG = kPW / 4;       // column groups of 4
constexpr int kThreads = 16 * kCG; // 16 row groups of 4
// C^T, B, G^T (then M^T), x by parity, the vectors by parity, S^T
constexpr int kSmemFloats = 3 * kTile + 2 * T * kPW + 2 * 4 * T + T * kPW;

struct Args {
  const float* x;
  const float* dt;
  const float* A;
  const float* bm;
  const float* cm;
  float* y;
  float* tiles;    // [B, nc, 3, T, T]: G^T (j, i), C^T (n, i), B (j, n)
  float* vecs;     // [B, nc, H, 4, T]: dt, cum, exp(cum), exp(last - cum)
  int S, H, P, N, Q, nc;
  bool x_vec;      // x rows 16-byte aligned: 16-byte copies
  int64_t xs[4];   // strides of x (b, s, h, p), in elements
  int64_t ds[3];   // dt (b, s, h)
  int64_t bs[3];   // B (b, s, n)
  int64_t cs[3];   // C (b, s, n)
  int64_t a_rs;    // A's stride between batch rows (0: one A for all)
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 (or 4) bytes, src_bytes of them read, the rest zero
__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp4(float* dst, const float* src,
                                    int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// One block per (chunk, b): the head-independent tiles and, per head, the
// in-order cumsum and its exponentials.
__global__ void __launch_bounds__(kPrepThreads)
    ssd_prep_kernel(const Args a) {
  __shared__ float Cs[T][T + 1];   // (i, n)
  __shared__ float Bs[T][T + 1];   // (j, n)
  const int ch = (int)blockIdx.x, b = (int)blockIdx.y, tid = threadIdx.x;
  const int Q = a.Q, N = a.N, s0 = ch * Q;
  const int qv = min(Q, a.S - s0);   // rows of this chunk in the sequence
  const float* Bb = a.bm + b * a.bs[0];
  const float* Cb = a.cm + b * a.cs[0];
  for (int e = tid; e < kTile; e += kPrepThreads) {
    const int r = e / T, k = e % T;
    const bool in = r < qv && k < N;
    const int64_t t = s0 + r;
    Cs[r][k] = in ? Cb[t * a.cs[1] + k * a.cs[2]] : 0.f;
    Bs[r][k] = in ? Bb[t * a.bs[1] + k * a.bs[2]] : 0.f;
  }
  __syncthreads();

  float* tile = a.tiles + ((int64_t)b * a.nc + ch) * 3 * kTile;
  {  // G^T[j][i] = C_i . B_j for j <= i < Q, else 0; rows j < Q
    const int j0 = (tid / 16) * 4, i0 = (tid % 16) * 4;
    float acc[4][4];   // (i0 + r, j0 + c)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    if (i0 + 3 >= j0) {
      for (int k = 0; k < N; ++k) {
        const float4 c4 = make_float4(Cs[i0][k], Cs[i0 + 1][k],
                                      Cs[i0 + 2][k], Cs[i0 + 3][k]);
        const float4 b4 = make_float4(Bs[j0][k], Bs[j0 + 1][k],
                                      Bs[j0 + 2][k], Bs[j0 + 3][k]);
        fma_tile(acc, c4, b4);
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + c;
      if (j >= Q) continue;
      float v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + r;
        v[r] = j <= i && i < Q ? acc[r][c] : 0.f;
      }
      *reinterpret_cast<float4*>(tile + j * T + i0) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  for (int e = tid; e < kTile; e += kPrepThreads) {
    const int r = e / T, k = e % T;
    if (r < N) tile[kTile + e] = Cs[k][r];        // C^T[n = r][i = k]
    if (r < Q) tile[2 * kTile + e] = Bs[r][k];    // B[j = r][n = k]
  }

  // per head, one warp: every lane runs the same in-order chain (the same
  // additions in the same order, so the same bits in every lane) and keeps
  // the entries i = lane and lane + 32, which it writes coalesced
  const float* db = a.dt + b * a.ds[0] + (int64_t)s0 * a.ds[1];
  const int warp = tid / 32, lane = tid % 32;
  for (int hh = warp; hh < a.H; hh += kPrepThreads / 32) {
    const float Ah = a.A[b * a.a_rs + hh];
    const float* dh = db + hh * a.ds[2];
    const float d0 = lane < qv ? dh[(int64_t)lane * a.ds[1]] : 0.f;
    const float d1 = lane + 32 < qv ? dh[(int64_t)(lane + 32) * a.ds[1]] : 0.f;
    float c = 0.f, last = 0.f, cum0 = 0.f, cum1 = 0.f;
#pragma unroll
    for (int i = 0; i < T; ++i) {   // in order: see the note at the top
      const float di = __shfl_sync(0xffffffffu, i < 32 ? d0 : d1, i & 31);
      c = __fadd_rn(c, i < qv ? __fmul_rn(di, Ah) : 0.f);
      if (i == lane) cum0 = c;
      if (i == lane + 32) cum1 = c;
      if (i == Q - 1) last = c;
    }
    float* v = a.vecs + (((int64_t)b * a.nc + ch) * a.H + hh) * 4 * T;
    v[lane] = d0;
    v[lane + 32] = d1;
    v[T + lane] = cum0;
    v[T + lane + 32] = cum1;
    v[2 * T + lane] = expf(cum0);
    v[2 * T + lane + 32] = expf(cum1);
    v[3 * T + lane] = expf(last - cum0);
    v[3 * T + lane + 32] = expf(last - cum1);
  }
}

// A thread's tiles are 4 x 4: on an H100 at zamba2's shape, 4 x 2 tiles
// (twice the warps) and 4 x 8 tiles (half the shared-memory loads per
// multiply-add) both ran slower (PERF.md). kFull: Q = N = 64, so
// every loop bound is a constant (0.8006 ms against 0.8566 for the
// general instantiation at zamba2's shape, the same bits).
template <bool kFull>
__global__ void __launch_bounds__(kThreads, 3)
    ssd_scan_kernel(const Args a, int n_slices) {
  extern __shared__ float4 smem4[];
  float* Ct = reinterpret_cast<float*>(smem4);   // [n][i]
  float* Bn = Ct + kTile;                        // [j][n]
  float* Mt = Bn + kTile;                        // [j][i] G^T, then M^T
  float* Xs = Mt + kTile;                        // [parity][j][p] dt x
  float* Vs = Xs + 2 * T * kPW;                  // [parity][4][T]
  float* St = Vs + 2 * 4 * T;                    // [n][p] state

  const int sl = (int)blockIdx.x % n_slices;
  const int bh = (int)blockIdx.x / n_slices;
  const int b = bh / a.H, h = bh % a.H;
  const int tid = threadIdx.x;
  const int r0 = (tid / kCG) * 4;    // rows i (y) and n (state)
  const int c0 = (tid % kCG) * 4;    // columns of the slice
  const int Q = kFull ? T : a.Q, N = kFull ? T : a.N, P = a.P, nc = a.nc;
  const int pbase = sl * kPW;
  const int Qp = (Q + 3) / 4 * 4, Np = (N + 3) / 4 * 4;
  const float* xb = a.x + b * a.xs[0] + h * a.xs[2];
  const float* tiles_b = a.tiles + (int64_t)b * nc * 3 * kTile;
  const int64_t y_row = (int64_t)a.H * P;
  float* yb = a.y + ((int64_t)b * a.S * a.H + h) * P + pbase;

  // G^T rows j from column 4 floor(j / 4), and C^T, of chunk ch
  auto load_cg = [&](int ch) {
    const float* src = tiles_b + (int64_t)ch * 3 * kTile;
    for (int e = tid; e < Q * (T / 4); e += kThreads) {
      const int j = e / (T / 4), q = (e % (T / 4)) * 4;
      if (q >= (j & ~3) && q < Qp) cp16(Mt + j * T + q, src + j * T + q, 16);
    }
    for (int e = tid; e < N * (T / 4); e += kThreads) {
      const int n = e / (T / 4), q = (e % (T / 4)) * 4;
      if (q < Qp) cp16(Ct + n * T + q, src + kTile + n * T + q, 16);
    }
  };
  auto load_b = [&](int ch) {
    const float* src = tiles_b + ((int64_t)ch * 3 + 2) * kTile;
    for (int e = tid; e < Q * (T / 4); e += kThreads) {
      const int j = e / (T / 4), q = (e % (T / 4)) * 4;
      if (q < Np) cp16(Bn + j * T + q, src + j * T + q, 16);
    }
  };
  // x rows j < Q (zero past the sequence and past P) and the vectors
  auto load_xv = [&](int ch, int par) {
    const float* v =
        a.vecs + (((int64_t)b * nc + ch) * a.H + h) * 4 * T;
    float* vd = Vs + par * 4 * T;
    for (int e = tid; e < T; e += kThreads) cp16(vd + 4 * e, v + 4 * e, 16);
    float* xd = Xs + par * T * kPW;
    const int s0 = ch * Q, qv = min(Q, a.S - s0);
    if (a.x_vec) {
      for (int e = tid; e < Q * (kPW / 4); e += kThreads) {
        const int j = e / (kPW / 4), q = (e % (kPW / 4)) * 4;
        const int p = pbase + q;
        const int n = j < qv && p < P ? 4 * min(4, P - p) : 0;
        cp16(xd + j * kPW + q,
             n ? xb + (int64_t)(s0 + j) * a.xs[1] + p : a.x, n);
      }
    } else {
      for (int e = tid; e < Q * kPW; e += kThreads) {
        const int j = e / kPW, q = e % kPW, p = pbase + q;
        const bool in = j < qv && p < P;
        cp4(xd + j * kPW + q,
            in ? xb + (int64_t)(s0 + j) * a.xs[1] + p * a.xs[3] : a.x,
            in ? 4 : 0);
      }
    }
  };

  float st[4][4];   // state (n = r0 + r, p = c0 + c)
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) st[r][c] = 0.f;
  for (int e = tid; e < T * kPW; e += kThreads) St[e] = 0.f;
  load_cg(0);
  load_xv(0, 0);
  cp_commit();

  for (int ch = 0; ch < nc; ++ch) {
    const int cur = ch & 1;
    const int s0 = ch * Q, qv = min(Q, a.S - s0);
    float* X = Xs + cur * T * kPW;
    const float* dtv = Vs + cur * 4 * T;
    const float* cum = dtv + T;
    const float* eC = dtv + 2 * T;
    const float* dec = dtv + 3 * T;
    cp_wait_all();
    __syncthreads();   // this chunk's G, C, x and vectors; the last state
    if (ch + 1 < nc) load_xv(ch + 1, cur ^ 1);
    load_b(ch);
    cp_commit();

    // (1) dt x in place, and M^T[j][i] = G^T[j][i] exp(cum_i - cum_j) for
    // j <= i in place (the zeros below the diagonal stay)
    for (int e = tid; e < Q * kPW; e += kThreads)
      X[e] = __fmul_rn(dtv[e / kPW], X[e]);
    // lane l takes the columns i = l and 63 - l, warp w the rows j = w, w +
    // warps, ... up to i: the same count of entries in every lane
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const int i = half ? T - 1 - (tid % 32) : tid % 32;
      if (i >= Q) continue;
      const float ci = cum[i];
      for (int j = tid / 32; j <= i; j += kThreads / 32)
        Mt[j * T + i] = Mt[j * T + i] * expf(ci - cum[j]);
    }
    __syncthreads();

    // (2) y = exp(cum_i) (C_i . S) + sum_{j <= i} M^T[j][i] (dt x)_j
    if (r0 < Q) {
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 8
      for (int k = 0; k < N; ++k)
        fma_tile(acc, ld4(Ct + k * T + r0), ld4(St + k * kPW + c0));
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float e = eC[r0 + r];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] *= e;
      }
      const int jmax = min(Q, r0 + 4);
#pragma unroll 4
      for (int j = 0; j < jmax; ++j)
        fma_tile(acc, ld4(Mt + j * T + r0), ld4(X + j * kPW + c0));
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = r0 + r;
        if (i >= qv) continue;
        float* yr = yb + (int64_t)(s0 + i) * y_row + c0;
        if (P % 4 == 0 && pbase + c0 < P) {
          *reinterpret_cast<float4*>(yr) =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (pbase + c0 + c < P) yr[c] = acc[r][c];
        }
      }
    }
    cp_wait_all();
    __syncthreads();   // B of this chunk; every read of S, C and M is done
    if (ch + 1 < nc) load_cg(ch + 1);
    cp_commit();

    // (3) S <- exp(cum_last) S + sum_j B_j ⊗ exp(cum_last - cum_j) (dt x)_j
    if (r0 < N) {
      float upd[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) upd[r][c] = 0.f;
#pragma unroll 8
      for (int j = 0; j < Q; ++j) {
        const float d = dec[j];
        float4 x4 = ld4(X + j * kPW + c0);
        x4 = make_float4(d * x4.x, d * x4.y, d * x4.z, d * x4.w);
        fma_tile(upd, ld4(Bn + j * T + r0), x4);
      }
      const float decay = eC[Q - 1];   // expf(cum[Q - 1])
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) st[r][c] = st[r][c] * decay + upd[r][c];
        *reinterpret_cast<float4*>(St + (r0 + r) * kPW + c0) =
            make_float4(st[r][0], st[r][1], st[r][2], st[r][3]);
      }
    }
  }
}

template <bool kFull>
cudaError_t launch_scan(const Args& a, int B, cudaStream_t stream) {
  const int n_slices = (a.P + kPW - 1) / kPW;
  if ((long long)B * a.H * n_slices > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const int bytes = kSmemFloats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<kFull>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<kFull><<<(unsigned)(B * a.H * n_slices), kThreads, bytes,
                           stream>>>(a, n_slices);
  return cudaGetLastError();
}

}  // namespace

// strides: x (b, s, h, p), dt (b, s, h), B (b, s, n), C (b, s, n), in
// elements; y is written contiguous [B, S, H, P]. tiles [B, n_chunks, 3, 64,
// 64] and vecs [B, n_chunks, H, 4, 64] are f32 scratch. Row b's A is at
// A + b * a_rs: a_rs = 0 for A [H], H for A [B, H].
extern "C" int ssd_scan_f32(const void* x, const void* dt, const void* A,
                            long long a_rs, const void* Bm, const void* Cm,
                            void* y, void* tiles, void* vecs, int B, int S,
                            int H, int P, int N, int chunk,
                            const long long* strides, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || H < 1 || P < 1 || P > T || N < 1 ||
      N > T || chunk < 1 || chunk > T || a_rs < 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = static_cast<const float*>(x);
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.a_rs = a_rs;
  a.bm = static_cast<const float*>(Bm);
  a.cm = static_cast<const float*>(Cm);
  a.y = static_cast<float*>(y);
  a.tiles = static_cast<float*>(tiles);
  a.vecs = static_cast<float*>(vecs);
  a.S = S;
  a.H = H;
  a.P = P;
  a.N = N;
  a.Q = chunk;
  a.nc = (S + chunk - 1) / chunk;
  for (int i = 0; i < 4; ++i) a.xs[i] = strides[i];
  for (int i = 0; i < 3; ++i) {
    a.ds[i] = strides[4 + i];
    a.bs[i] = strides[7 + i];
    a.cs[i] = strides[10 + i];
  }
  a.x_vec = a.xs[3] == 1 && a.xs[0] % 4 == 0 && a.xs[1] % 4 == 0 &&
            a.xs[2] % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ssd_prep_kernel<<<dim3((unsigned)a.nc, (unsigned)B), kPrepThreads, 0, st>>>(
      a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)(chunk == T && N == T ? launch_scan<true>(a, B, st)
                                     : launch_scan<false>(a, B, st));
}
