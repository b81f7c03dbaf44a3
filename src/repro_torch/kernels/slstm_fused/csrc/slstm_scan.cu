// slstm_scan for Hopper (sm_90a): the sequential sLSTM recurrence.
//
// Replaces the Pallas TPU kernel src/repro/kernels/slstm_fused/kernel.py
// (_slstm_kernel / slstm_scan_pallas). Per batch row b and head h, over the
// S time steps in order, with rec_g = h_{t-1} @ r[g, h] for the gates
// g = z, i, f, o:
//
//   m = max(logsig(f) + m, i);  i' = exp(i - m_new);  f' = exp(logsig(f) + m - m_new)
//   c = f' c + i' tanh(z);  n = f' n + i';  h = sigmoid(o) c / max(n, 1e-6)
//
// from h = c = n = 0 and m = -1e30 (so the first step's f' is exactly 0).
// The state is not returned (the TPU kernel's scratch, kernel.py:28-37).
//
// Shapes: pre [B, S, 4, H, P] and r [4, H, P, P], f32, read in place
// through their strides; h is a new contiguous [B, S, H, P].
//
// What bounds it: at xlstm-350m's prefill (B 2, S 4096, H 4, P 256) the
// products are 17.2 GFLOP (0.26 ms at the fp32 peak) against 172 MB of
// input and output (0.05 ms), but they form a chain of 4,096 dependent
// steps, and each step needs the whole h_{t-1} of a head and all of its
// r[:, h], 1 MiB, four times what one SM's shared memory holds. So the
// time is set by the latency of one step, not by the bytes or the FLOPs.
//
// Design (simple and right first):
// - One thread block cluster of 8 CTAs per (b, h); clusters never wait on
//   each other, so any number of them may be co-resident. CTA k owns the
//   columns [k ceil(P/8), (k+1) ceil(P/8)) of all four gates and keeps
//   its [4, P, ceil(P/8)] slice of r[:, h] in shared memory for the whole
//   sweep (131,072 bytes at P 256), so r is read from device memory once.
// - Its warp 0 keeps c, n and m of its columns in registers, one column a
//   lane. Each step: the 16 warps, one per (gate, quarter of the p axis),
//   form partial dot products of h_{t-1} (a broadcast float4 read of the
//   CTA's own copy) with the r slice (conflict-free: lane = column); warp
//   0 sums the four quarters in order, applies the cell update, writes h_t
//   to device memory and into the h buffer of every CTA of the cluster
//   (distributed shared memory), and all threads of the cluster meet at
//   one cluster barrier. The h buffer is doubled by step parity: a CTA
//   that passed the barrier of step t writes buffer (t+1)&1 only, which no
//   CTA reads before the barrier of step t+1, and the barrier's release
//   and acquire make the writes visible. One barrier a step suffices.
// - A CTA that owns no column (P < 8 leaves some) still meets every
//   barrier. P not a multiple of 16 is padded in shared memory with zero
//   rows of r and zero entries of h, never in device memory.
// - Per step and CTA the r slice is read once from shared memory (128 B a
//   cycle an SM): ~1,024 cycles at P 256, the floor of this design.
// - Arithmetic is fp32 with expf, tanhf and log1pf (no fast math);
//   logsig(x) = min(x, 0) - log1p(exp(-|x|)) cannot overflow.
// - Not in this version: r in registers (the slice is 64 registers a
//   thread at 512 threads), the tensor cores, and overlap of the next
//   step's products with the barrier.
// - The launch allocates nothing and returns cudaGetLastError();
//   slstm_scan_max_clusters tells the wrapper whether a cluster fits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;                 // CTAs per (b, h)
constexpr int kCols = 32;                   // columns a CTA owns at most
constexpr int kMaxP = kCluster * kCols;     // 256
constexpr int kSeg = 4;                     // quarters of the p axis
constexpr int kThreads = 4 * kSeg * 32;     // a warp per (gate, quarter)

struct Args {
  const float* pre;
  const float* r;
  float* h;
  int S, H, P;
  int64_t ps[5];   // strides of pre (b, s, g, h, p), in elements
  int64_t rs[4];   // strides of r (g, h, p, q)
};

// P rounded up so that each quarter is a whole number of float4
__host__ __device__ constexpr int padded(int p) {
  return (p + 4 * kSeg - 1) / (4 * kSeg) * (4 * kSeg);
}

// r slice [4][Pp][kCols], h [2][Pp], partial sums [kSeg][4][kCols]
size_t smem_bytes(int p) {
  const int pp = padded(p);
  return sizeof(float) *
         ((size_t)4 * pp * kCols + 2 * pp + kSeg * 4 * kCols);
}

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__global__ void __launch_bounds__(kThreads, 1)
    slstm_scan_kernel(const Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  const int P = a.P, Pp = padded(P);
  float* rsl = reinterpret_cast<float*>(smem4);   // [g][p][c]
  float* hbuf = rsl + 4 * Pp * kCols;             // [parity][p]
  float* part = hbuf + 2 * Pp;                    // [quarter][g][c]

  const int rank = (int)cluster.block_rank();
  const int bh = (int)blockIdx.x / kCluster;
  const int b = bh / a.H, h = bh % a.H;
  const int per = (P + kCluster - 1) / kCluster;
  const int col0 = rank * per;
  const int ncols = max(0, min(per, P - col0));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  for (int e = tid; e < 4 * Pp * kCols; e += kThreads) {
    const int c = e % kCols, p = (e / kCols) % Pp, g = e / (kCols * Pp);
    rsl[e] = c < ncols && p < P
                 ? a.r[g * a.rs[0] + h * a.rs[1] + p * a.rs[2] +
                       (int64_t)(col0 + c) * a.rs[3]]
                 : 0.f;
  }
  for (int e = tid; e < 2 * Pp; e += kThreads) hbuf[e] = 0.f;
  // every CTA of the cluster runs, and has zeroed its h, before any
  // remote write
  cluster.sync();

  const int g = warp & 3, seg = warp >> 2;
  const int L = Pp / kSeg;
  const float* rw = rsl + (g * Pp + seg * L) * kCols + lane;
  const bool owner = warp == 0 && lane < ncols;
  const float* pre_c = a.pre + b * a.ps[0] + h * a.ps[3] +
                       (int64_t)(col0 + lane) * a.ps[4];
  float* out_c = a.h + ((int64_t)b * a.S * a.H + h) * P + col0 + lane;
  const int64_t out_row = (int64_t)a.H * P;
  float c_st = 0.f, n_st = 0.f, m_st = -1e30f;   // the owner's column

  for (int t = 0; t < a.S; ++t) {
    const int cur = t & 1;
    float px[4] = {0.f, 0.f, 0.f, 0.f};   // pre of z, i, f, o
    if (owner) {   // issued now, used after the products
      const float* pt = pre_c + t * a.ps[1];
#pragma unroll
      for (int q = 0; q < 4; ++q) px[q] = pt[q * a.ps[2]];
    }
    const float* hp = hbuf + cur * Pp + seg * L;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int k = 0; k < L; k += 4) {
      const float4 h4 = *reinterpret_cast<const float4*>(hp + k);
      acc[0] = fmaf(h4.x, rw[(k + 0) * kCols], acc[0]);
      acc[1] = fmaf(h4.y, rw[(k + 1) * kCols], acc[1]);
      acc[2] = fmaf(h4.z, rw[(k + 2) * kCols], acc[2]);
      acc[3] = fmaf(h4.w, rw[(k + 3) * kCols], acc[3]);
    }
    part[(seg * 4 + g) * kCols + lane] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    __syncthreads();

    if (owner) {
      float x[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float rec = 0.f;
#pragma unroll
        for (int s = 0; s < kSeg; ++s) rec += part[(s * 4 + q) * kCols + lane];
        x[q] = px[q] + rec;
      }
      const float lf = log_sigmoid(x[2]);
      const float m_new = fmaxf(lf + m_st, x[1]);
      const float i_act = expf(x[1] - m_new);
      const float f_act = expf(lf + m_st - m_new);
      c_st = f_act * c_st + i_act * tanhf(x[0]);
      n_st = f_act * n_st + i_act;
      m_st = m_new;
      const float hn = sigmoid(x[3]) * c_st / fmaxf(n_st, 1e-6f);
      out_c[t * out_row] = hn;
      if (t + 1 < a.S) {
        float* dst = hbuf + (cur ^ 1) * Pp + col0 + lane;
#pragma unroll
        for (int k = 0; k < kCluster; ++k)
          *cluster.map_shared_rank(dst, k) = hn;
      }
    }
    // release of this step's h writes, acquire of the others'
    cluster.sync();
  }
}

cudaLaunchConfig_t launch_config(int n_clusters, int p, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n_clusters * kCluster), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes(p);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// How many clusters of the kernel at head width P fit the card at once
// (0: the kernel cannot run there).
extern "C" int slstm_scan_max_clusters(int P, int* out) {
  if (P < 1 || P > kMaxP) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      slstm_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(P));
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(1, P, 0, &attr);
  return (int)cudaOccupancyMaxActiveClusters(out, slstm_scan_kernel, &cfg);
}

// strides: pre (b, s, g, h, p), r (g, h, p, q), in elements; h is written
// contiguous [B, S, H, P]
extern "C" int slstm_scan_f32(const void* pre, const void* r, void* h, int B,
                              int S, int H, int P, const long long* strides,
                              void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || P > kMaxP ||
      (long long)B * H * kCluster > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.pre = static_cast<const float*>(pre);
  a.r = static_cast<const float*>(r);
  a.h = static_cast<float*>(h);
  a.S = S;
  a.H = H;
  a.P = P;
  for (int i = 0; i < 5; ++i) a.ps[i] = strides[i];
  for (int i = 0; i < 4; ++i) a.rs[i] = strides[5 + i];
  cudaError_t err = cudaFuncSetAttribute(
      slstm_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(P));
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      launch_config(B * H, P, static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(&cfg, slstm_scan_kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
