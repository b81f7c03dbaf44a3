// flash_attention for Hopper (sm_90a): out = softmax(scale * q k^T + mask) v.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_attn_kernel / flash_attention_pallas): the forward of blockwise GQA
// attention with an online softmax, right-aligned queries (query i sits at
// position i + Sk - S), a causal mask and a sliding window.
//
// Shapes: q [B, S, H, D], k and v [B, Sk, KV, D] with H % KV == 0, read in
// place through their strides (the last dimension contiguous); the output is
// a new contiguous [B, S, H, D] in q's type. Query head h reads KV head
// h / (H / KV); repeated KV heads are never materialised.
//
// What bounds it: operations. A (q, k) pair costs 4 D operations (q.k and
// p.v) against a few bytes of q, k, v and out per pair, so at the model's
// shapes the least time is the unmasked pairs' operations over the card's
// peak. This kernel runs them on the CUDA cores in fp32, far from that
// bound. It serves float32 (every head dim) and bf16 at head dims 8, 16
// and 32; bf16 at 64, 80, 128 and 256, every served model's prefill, runs
// on the tensor cores (flash_attention_tc.cu).
//
// Design (simple and right first):
// - One block of 256 threads per (b * H + h, tile of 64 queries); the
//   block walks the key blocks of 64 that its tile needs in a loop, which
//   takes the place of the TPU's sequential grid axis. Query tiles are
//   issued last-first, so the longest causal rows start first.
// - Whole key blocks outside [q_start - window, q_start + 64) are skipped
//   by the loop bounds; the edge blocks are masked per (query, key) pair,
//   and keys at or past Sk are masked and read as zeros.
// - Arithmetic is fp32 throughout, as in the Pallas kernel. q (pre-scaled
//   by `scale`) and k are staged transposed in shared memory, so that a
//   thread reads four queries and four keys as two float4 per step of d and
//   keeps a 4 x 4 tile of scores; v is staged row-major and each thread
//   owns four query rows x D / 16 output columns of the fp32 accumulator,
//   which stays in registers for the whole loop. D is a template: the
//   powers of two from 8 to 256, and 80 (zamba2's shared attention), whose
//   80 columns are a 64-wide strip read as float4 plus a 16-wide rest read
//   one column a thread, so the 16 threads of a row cover [0, 80) exactly
//   (q, k, v are not padded to 128).
// - The running max and sum of each row live in shared memory; four
//   threads reduce each row with warp shuffles.
// - Masked scores are -1e30, not -inf. A row whose first visited block is
//   fully masked (possible with a window) then accumulates finite garbage
//   with m = -1e30, which the next block's correction exp(-1e30 - m) = 0
//   wipes out; with -inf that correction would be NaN. The final division
//   is by max(l, 1e-30), as in the Pallas kernel.
// - Shared memory is 4 (2 * 68 D + 64 D + 64 * 68 + 192) bytes: 217.75 KB
//   at D = 256 (80.25 KB at D = 80), one block per SM at D = 256, allowed by
//   cudaFuncAttributeMaxDynamicSharedMemorySize.
// - The launch allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int BQ = 64;           // queries per block
constexpr int BK = 64;           // keys per step of the loop
constexpr int LDQ = BQ + 4;      // pitch of the transposed q and p tiles
constexpr int LDK = BK + 4;      // pitch of the transposed k tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
constexpr int smem_floats() {
  return D * LDQ + D * LDK + BK * D + BK * LDQ + 3 * BQ;
}

// Rows [row0, row0 + 64) of a [nrows, D] matrix (row stride ld) into
// dst[d * pitch + r] as fp32 times `mul`; rows at or past nrows read as 0.
// A warp covers 4 rows x 8 columns per step: 32 distinct banks on the
// transposed store (pitch = 4 mod 32), one 32-byte sector per row on the
// load.
template <int D, typename T>
__device__ __forceinline__ void load_transposed(float* dst, int pitch,
                                                const T* base, int64_t ld,
                                                int row0, int nrows,
                                                float mul) {
  constexpr int CG = D / 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int c = warp; c < (64 / 4) * CG; c += kThreads / 32) {
    const int r = (c / CG) * 4 + lane / 8;
    const int d = (c % CG) * 8 + lane % 8;
    const int row = row0 + r;
    dst[d * pitch + r] =
        row < nrows ? to_f32(base[(int64_t)row * ld + d]) * mul : 0.f;
  }
}

// Rows [row0, row0 + 64) of a [nrows, D] matrix into dst[r * D + d].
template <int D, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* base,
                                          int64_t ld, int row0, int nrows) {
  for (int e = threadIdx.x; e < 64 * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int row = row0 + r;
    dst[e] = row < nrows ? to_f32(base[(int64_t)row * ld + d]) : 0.f;
  }
}

// Column j of a thread's accumulator. For D >= 64: four columns of each
// 64-wide strip (float4 reads of v), then, where D is not a multiple of 64
// (D = 80), one stride-16 column of each 16-wide rest; for D < 64 a
// stride-16 column (idle where it passes D).
template <int D>
__device__ __forceinline__ int acc_col(int j, int tx) {
  constexpr int J4 = 4 * (D / 64);   // columns in the 64-wide strips
  if (D < 64) return tx + 16 * j;
  return j < J4 ? (j / 4) * 64 + tx * 4 + (j % 4)
                : (D / 64) * 64 + tx + 16 * (j - J4);
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int S, int Sk, int H, int KV, int64_t q_sb,
                           int64_t q_ss, int64_t q_sh, int64_t k_sb,
                           int64_t k_ss, int64_t k_sh, int64_t v_sb,
                           int64_t v_ss, int64_t v_sh, float scale,
                           int causal, int window) {
  constexpr int DC = D >= 16 ? D / 16 : 1;   // accumulator columns a thread
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);   // [D][LDQ], q * scale
  float* kT = qT + D * LDQ;                      // [D][LDK]
  float* vs = kT + D * LDK;                      // [BK][D]
  float* pT = vs + BK * D;                       // [BK][LDQ] scores, then p
  float* m_s = pT + BK * LDQ;                    // running max per row
  float* l_s = m_s + BQ;                         // running sum per row
  float* c_s = l_s + BQ;                         // this step's correction

  const int nq = (S + BQ - 1) / BQ;
  const int qi = nq - 1 - (int)blockIdx.x;
  const int b = (int)blockIdx.y / H, h = (int)blockIdx.y % H;
  const int kvh = h / (H / KV);
  const int row0 = qi * BQ;
  const int q_start = row0 + Sk - S;   // position of the tile's first query
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  // key blocks the tile needs: k_start < q_start + BQ (causal) and
  // k_start + BK > q_start - window (window). The wrapper refuses causal
  // calls with S > Sk, so every causal row has at least key 0.
  const int nk = (Sk + BK - 1) / BK;
  int hi = nk;
  if (causal) {
    const int need = q_start + BQ;   // keys [0, need) can be unmasked
    hi = need <= 0 ? 0 : min(nk, (need + BK - 1) / BK);
  }
  int lo = 0;
  if (window > 0) {
    const int t = q_start - window - BK;
    lo = t < 0 ? 0 : t / BK + 1;
  }

  if (tid < BQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  load_transposed<D>(qT, LDQ, q + (int64_t)b * q_sb + (int64_t)h * q_sh,
                     q_ss, row0, S, scale);

  float acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[r][j] = 0.f;

  const T* kb = k + (int64_t)b * k_sb + (int64_t)kvh * k_sh;
  const T* vb = v + (int64_t)b * v_sb + (int64_t)kvh * v_sh;
  for (int kj = lo; kj < hi; ++kj) {
    const int k_start = kj * BK;
    __syncthreads();   // the previous step is done with kT, vs, pT, c_s
    load_transposed<D>(kT, LDK, kb, k_ss, k_start, Sk, 1.f);
    load_rows<D>(vs, vb, v_ss, k_start, Sk);
    __syncthreads();

    // scores of queries ty*4 + r against keys tx*4 + c
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a4 = *reinterpret_cast<const float4*>(qT + d * LDQ + ty * 4);
      const float4 b4 = *reinterpret_cast<const float4*>(kT + d * LDK + tx * 4);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bk[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(a[r], bk[c], s[r][c]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int kpos = k_start + tx * 4 + c;
      float col[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int qpos = q_start + ty * 4 + r;
        bool ok = kpos < Sk;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        col[r] = ok ? s[r][c] : kNegInf;
      }
      *reinterpret_cast<float4*>(pT + (tx * 4 + c) * LDQ + ty * 4) =
          make_float4(col[0], col[1], col[2], col[3]);
    }
    __syncthreads();

    // online softmax: four neighbouring lanes per query row
    {
      const int row = tid / 4, part = tid % 4;
      float mx = kNegInf;
      for (int j = part; j < BK; j += 4) mx = fmaxf(mx, pT[j * LDQ + row]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[row];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = part; j < BK; j += 4) {
        const float p = expf(pT[j * LDQ + row] - m_new);
        pT[j * LDQ + row] = p;
        sum += p;
      }
      // the shuffles also order every lane's read of m_s[row] before the
      // write below
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[row] = l_s[row] * corr + sum;
        m_s[row] = m_new;
        c_s[row] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p v
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float corr = c_s[ty * 4 + r];
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[r][j] *= corr;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 p4 = *reinterpret_cast<const float4*>(pT + kk * LDQ + ty * 4);
      const float p[4] = {p4.x, p4.y, p4.z, p4.w};
      if constexpr (D >= 64) {
#pragma unroll
        for (int j4 = 0; j4 < D / 64; ++j4) {
          const float4 v4 = *reinterpret_cast<const float4*>(
              vs + kk * D + j4 * 64 + tx * 4);
          const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[r][j4 * 4 + c] = fmaf(p[r], vv[c], acc[r][j4 * 4 + c]);
        }
#pragma unroll
        for (int jr = 0; jr < (D % 64) / 16; ++jr) {
          const int j = 4 * (D / 64) + jr;
          const float x = vs[kk * D + acc_col<D>(j, tx)];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][j] = fmaf(p[r], x, acc[r][j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          const int col = tx + 16 * j;
          if (col < D) {
            const float x = vs[kk * D + col];
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[r][j] = fmaf(p[r], x, acc[r][j]);
          }
        }
      }
    }
  }
  __syncthreads();   // l_s is complete (and initialised when no step ran)

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = row0 + ty * 4 + r;
    if (row >= S) continue;
    const float l = fmaxf(l_s[ty * 4 + r], 1e-30f);
    T* o = out + (((int64_t)b * S + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int col = acc_col<D>(j, tx);
      if (col < D) store(o + col, acc[r][j] / l);
    }
  }
}

template <int D, typename T>
int launch_d(const T* q, const T* k, const T* v, T* out, int B, int S,
             int Sk, int H, int KV, const long long* st, float scale,
             int causal, int window, cudaStream_t stream) {
  auto kern = flash_attention_kernel<D, T>;
  const int bytes = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((S + BQ - 1) / BQ), (unsigned)(B * H));
  kern<<<grid, kThreads, bytes, stream>>>(q, k, v, out, S, Sk, H, KV, st[0],
                                          st[1], st[2], st[3], st[4], st[5],
                                          st[6], st[7], st[8], scale, causal,
                                          window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int Sk, int H, int KV, int D, const long long* st,
           float scale, int causal, int window, void* stream) {
  if (B < 1 || S < 1 || Sk < 1 || H < 1 || KV < 1 || H % KV != 0 ||
      (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* o = static_cast<T*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 8:
      return launch_d<8, T>(qq, kk, vv, o, B, S, Sk, H, KV, st, scale,
                            causal, window, s);
    case 16:
      return launch_d<16, T>(qq, kk, vv, o, B, S, Sk, H, KV, st, scale,
                             causal, window, s);
    case 32:
      return launch_d<32, T>(qq, kk, vv, o, B, S, Sk, H, KV, st, scale,
                             causal, window, s);
    default:
      break;
  }
  // the wide head dims in bf16 take the tensor-core kernel
  if constexpr (!std::is_same<T, float>::value) {
    return (int)cudaErrorInvalidValue;
  } else {
    switch (D) {
      case 64:
        return launch_d<64, T>(qq, kk, vv, o, B, S, Sk, H, KV, st, scale,
                               causal, window, s);
      case 80:
        return launch_d<80, T>(qq, kk, vv, o, B, S, Sk, H, KV, st, scale,
                               causal, window, s);
      case 128:
        return launch_d<128, T>(qq, kk, vv, o, B, S, Sk, H, KV, st, scale,
                                causal, window, s);
      case 256:
        return launch_d<256, T>(qq, kk, vv, o, B, S, Sk, H, KV, st, scale,
                                causal, window, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
}

}  // namespace

// strides: q (b, s, h), k (b, s, h), v (b, s, h), in elements;
// window < 1 means none
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out, int B, int S,
                                   int Sk, int H, int KV, int D,
                                   const long long* strides, float scale,
                                   int causal, int window, void* stream) {
  return launch<float>(q, k, v, out, B, S, Sk, H, KV, D, strides, scale,
                       causal, window, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int B, int S,
                                    int Sk, int H, int KV, int D,
                                    const long long* strides, float scale,
                                    int causal, int window, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, B, S, Sk, H, KV, D, strides,
                               scale, causal, window, stream);
}
