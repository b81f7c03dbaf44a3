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
// r[:, h], 1 MiB. So the time is the latency of one step, times S.
//
// Design:
// - One thread block cluster per head and group of up to kMaxRows batch
//   rows (B = 5 runs as two groups of 3 and 2), so each r value loaded is
//   used for every row of the group. CTA k of a cluster of kC owns the
//   columns [k per, (k+1) per) of all four gates, per = ceil(P / kC)
//   rounded up to 4 (at most 256 / kC).
// - r in registers for the whole sweep, never in shared memory: a thread
//   keeps r of two (gate, column) pairs over one segment of kL values of
//   the p axis; a warp is 64 pairs of one segment, so its h reads are
//   broadcasts, each feeding two multiply-adds. kC = 16 (a non-portable
//   cluster) gives 32 registers of r a thread. On an H100 at xlstm-350m's
//   shape 16-block clusters ran 4.01 ms and 8-block ones 4.41 (one pair a
//   thread: 4.20 and 4.97): the products halve with kC while the exchange
//   alone only rises from 0.32 to 0.39 us a step (PERF.md). A
//   cluster that the card cannot hold raises in the wrapper.
// - A step: wait on the CTA's own mbarrier for h_{t-1}; every thread forms
//   its segment's partial dot products for all rows (4 accumulators a row);
//   one __syncthreads; then one lane per (row, column) sums the segments in
//   order, applies the cell update, writes h_t to device memory, and the
//   lanes of four neighbouring columns push their float4 into the h buffer
//   of every CTA of the cluster with st.async, which completes bytes on
//   that CTA's mbarrier (no cluster-wide barrier a step). A CTA re-arms its
//   barrier with the bytes it expects (rows x P rounded to 4, x 4 bytes)
//   right after the wait. The h buffer and its barrier are doubled by step
//   parity: h_{t+1} can only be sent after every CTA has received h_t, so
//   after each CTA's products of step t have read the other buffer. (A
//   barrier per source CTA, each warp waiting only for the columns it
//   reads, ran no faster: 4.035 against 4.010 ms.)
// - pre arrives kRing steps ahead by cp.async into a per-lane ring in
//   shared memory, so its device-memory latency is off the chain.
// - No tensor cores: wgmma takes tiles of 64 rows, and a step here is a
//   [B <= 4, 256] x [256, 1024] product per head; and the recurrence stays
//   fp32, because xlstm's logits amplify 1e-7 differences in h about a
//   thousandfold (PERF.md). Arithmetic is fp32 with expf, tanhf and log1pf
//   (no fast math); logsig(x) = min(x, 0) - log1p(exp(-|x|)).
// - The sums run in another order than the plain version's (a segment's
//   four strided accumulators, then the segments in order), so the bits
//   differ from it by rounding; chip_smoke.py holds the kernel to it and
//   to a float64 run.
// - Two more entries time what one step costs without the products and the
//   cell (the step floor): mode 1 exchanges h through st.async and the
//   mbarriers as above, mode 2 through plain distributed-shared-memory
//   stores and a cluster barrier a step (the previous design's exchange).
// - The launch allocates nothing and returns cudaGetLastError();
//   slstm_scan_max_clusters tells the wrapper whether a cluster fits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxP = 256;      // the widest head
constexpr int kC = 16;          // CTAs a cluster (ops.CLUSTER)
constexpr int kMaxRows = 4;     // batch rows a cluster takes
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRing = 8;        // steps of pre in flight

struct Args {
  const float* pre;
  const float* r;
  float* h;
  int B, S, H, P, rows;   // rows: the batch rows of a full group
  int64_t ps[5];          // strides of pre (b, s, g, h, p), in elements
  int64_t rs[4];          // strides of r (g, h, p, q)
};

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the address of the same shared-memory word in CTA `rank` of the cluster
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
               : "memory");
}

// The one arrival of a phase, with the bytes its remote stores bring.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Returns once the phase of the given parity has completed, acquiring at
// cluster scope what the remote stores released; a phase that never
// completes traps after ~4M tries instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 22)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// v into the shared memory of another CTA (cluster addresses), completing
// 16 bytes on its barrier
__device__ __forceinline__ void st_async4(uint32_t dst, float4 v,
                                          uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];" ::"r"(dst),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Modes: 0 the scan; 1 and 2 the step floor (the h exchange alone), through
// st.async and the mbarriers (1) or DSMEM stores and cluster.sync (2).
template <int kNB, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
    slstm_scan_kernel(const Args a) {
  constexpr int kCols = kMaxP / kC;        // columns a CTA owns at most
  constexpr int kOC = 4 * kCols;           // (gate, column) pairs
  constexpr int kJ = 2;                    // pairs a thread
  constexpr int kWps = kOC / (32 * kJ);    // warps per segment
  constexpr int kSeg = kWarps / kWps;      // segments of the p axis
  constexpr int kL = kMaxP / kSeg;         // p values of a segment
  constexpr int kUpd = kNB * kCols;        // (row, column) lanes
  constexpr int kUpdWarps = (kUpd + 31) / 32;
  static_assert(kOC % (32 * kJ) == 0 && kL % 4 == 0 && kUpd <= kThreads,
                "shape");

  __shared__ __align__(16) float hbuf[2][kNB][kMaxP];       // h by parity
  __shared__ __align__(16) float part[kNB][kSeg][kOC];      // partial sums
  __shared__ __align__(16) float preq[kRing][kNB][kCols][4];
  __shared__ __align__(8) uint64_t bars[2];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cid = (int)blockIdx.x / kC;
  const int head = cid % a.H, b0 = (cid / a.H) * a.rows;
  const int nb = min(a.rows, a.B - b0);
  const int P = a.P, S = a.S;
  const int per = ((P + kC - 1) / kC + 3) / 4 * 4;
  const int col0 = rank * per;
  const int ncols = max(0, min(per, P - col0));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // the product role: pairs oc0 + 32 j, (gate, column) (oc / kCols,
  // oc % kCols), of segment seg
  const int oc0 = (warp % kWps) * 32 * kJ + lane;
  const int seg = warp / kWps;
  const int kbase = seg * kL;
  // the cell role: row ub, column uc
  const int ub = tid / kCols, uc = tid % kCols;
  const bool upd = tid < kUpd && ub < nb && uc < ncols;

  float rr[kJ][kL];
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const int g = (oc0 + 32 * j) / kCols, c = (oc0 + 32 * j) % kCols;
#pragma unroll
    for (int i = 0; i < kL; ++i) rr[j][i] = 0.f;
    if (kMode == 0 && c < ncols) {
      const float* rp = a.r + g * a.rs[0] + head * a.rs[1] +
                        (int64_t)(col0 + c) * a.rs[3];
#pragma unroll
      for (int i = 0; i < kL; ++i)
        if (kbase + i < P) rr[j][i] = rp[(int64_t)(kbase + i) * a.rs[2]];
    }
  }
  for (int e = tid; e < 2 * kNB * kMaxP; e += kThreads)
    (&hbuf[0][0][0])[e] = 0.f;

  const uint32_t bytes = (uint32_t)(nb * ((P + 3) / 4 * 4) * 4);
  const uint32_t bar0 = smem_addr(&bars[0]), bar1 = smem_addr(&bars[1]);
  if (kMode != 2 && tid == 0) {
    mbar_init(bar0);
    mbar_init(bar1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (S > 1) mbar_expect(bar0, bytes);   // h_0
    if (S > 2) mbar_expect(bar1, bytes);   // h_1
  }

  // pre of the first kRing steps, one commit group a step
  const float* pre_u = a.pre + (int64_t)(b0 + ub) * a.ps[0] +
                       head * a.ps[3] + (int64_t)(col0 + uc) * a.ps[4];
  if (kMode == 0) {
    for (int s = 0; s < kRing; ++s) {
      if (upd && s < S) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          cp_async4(smem_addr(&preq[s][ub][uc][q]),
                    pre_u + s * a.ps[1] + q * a.ps[2]);
      }
      cp_commit();
    }
  }
  // every CTA of the cluster has its barriers set and its h zeroed before
  // any remote store
  cluster.sync();

  float* out_u = a.h + ((int64_t)(b0 + ub) * S * a.H + head) * P + col0 + uc;
  const int64_t out_row = (int64_t)a.H * P;
  float c_st = 0.f, n_st = 0.f, m_st = -1e30f, hn = 0.f;

  for (int t = 0; t < S; ++t) {
    const int prev = (t + 1) & 1;   // the buffer of h_{t-1} (zeros at t 0)
    // in the floor's mode 1 only the sending warps take part: a warp that
    // neither sends nor meets a block barrier could fall two phases behind
    if (kMode != 2 && t > 0 && (kMode == 0 || warp < kUpdWarps)) {
      const uint32_t bar = prev ? bar1 : bar0;
      mbar_wait(bar, ((t - 1) >> 1) & 1);
      if (tid == 0 && t + 2 < S) mbar_expect(bar, bytes);   // h_{t+1}
    }

    if (kMode == 0) {
#pragma unroll
      for (int b = 0; b < kNB; ++b) {
        const float* hp = &hbuf[prev][b][kbase];
        float acc[kJ][4] = {};
#pragma unroll
        for (int i = 0; i < kL; i += 4) {
          const float4 h4 = *reinterpret_cast<const float4*>(hp + i);
#pragma unroll
          for (int j = 0; j < kJ; ++j) {
            acc[j][0] = fmaf(h4.x, rr[j][i + 0], acc[j][0]);
            acc[j][1] = fmaf(h4.y, rr[j][i + 1], acc[j][1]);
            acc[j][2] = fmaf(h4.z, rr[j][i + 2], acc[j][2]);
            acc[j][3] = fmaf(h4.w, rr[j][i + 3], acc[j][3]);
          }
        }
#pragma unroll
        for (int j = 0; j < kJ; ++j)
          part[b][seg][oc0 + 32 * j] =
              (acc[j][0] + acc[j][1]) + (acc[j][2] + acc[j][3]);
      }
      __syncthreads();
    }

    if (warp < kUpdWarps) {   // whole warps: the shuffles below
      if (kMode == 0) {
        cp_wait<kRing - 1>();        // pre of step t has landed
        if (upd) {
          float x[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float rec = 0.f;
#pragma unroll
            for (int s = 0; s < kSeg; ++s) rec += part[ub][s][q * kCols + uc];
            x[q] = preq[t % kRing][ub][uc][q] + rec;
          }
          const float lf = log_sigmoid(x[2]);
          const float m_new = fmaxf(lf + m_st, x[1]);
          const float i_act = expf(x[1] - m_new);
          const float f_act = expf(lf + m_st - m_new);
          c_st = f_act * c_st + i_act * tanhf(x[0]);
          n_st = f_act * n_st + i_act;
          m_st = m_new;
          hn = sigmoid(x[3]) * c_st / fmaxf(n_st, 1e-6f);
          out_u[t * out_row] = hn;
          // the slot just read takes step t + kRing
          if (t + kRing < S) {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              cp_async4(smem_addr(&preq[t % kRing][ub][uc][q]),
                        pre_u + (t + kRing) * a.ps[1] + q * a.ps[2]);
          }
        }
        cp_commit();
      } else if (upd) {              // the floor: h_t = h_{t-1} + 1
        hn = hbuf[prev][ub][col0 + uc] + 1.f;
        if (t + 1 == S) out_u[t * out_row] = hn;
      }
      if (t + 1 < S) {
        const int cur = t & 1;
        if (kMode == 2) {
          if (upd) {
            float* dst = &hbuf[cur][ub][col0 + uc];
            for (int k = 0; k < kC; ++k) *cluster.map_shared_rank(dst, k) = hn;
          }
        } else {
          // lanes of 4 neighbouring columns (one row; per is a multiple
          // of 4) pack their h into the first lane's float4
          float4 v;
          v.x = hn;
          v.y = __shfl_down_sync(0xffffffffu, hn, 1);
          v.z = __shfl_down_sync(0xffffffffu, hn, 2);
          v.w = __shfl_down_sync(0xffffffffu, hn, 3);
          if (upd && uc % 4 == 0) {
            if (uc + 1 >= ncols) v.y = 0.f;   // columns past P
            if (uc + 2 >= ncols) v.z = 0.f;
            if (uc + 3 >= ncols) v.w = 0.f;
            const uint32_t dst = smem_addr(&hbuf[cur][ub][col0 + uc]);
            const uint32_t bar = cur ? bar1 : bar0;
#pragma unroll 4
            for (int k = 0; k < kC; ++k)
              st_async4(map_rank(dst, k), v, map_rank(bar, k));
          }
        }
      }
    }
    if (kMode == 2) cluster.sync();
  }
  // no CTA leaves while another may still address its shared memory
  cluster.sync();
}

template <int kNB, int kMode>
cudaError_t configure(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                      int n_clusters, cudaStream_t stream) {
  // 16 CTAs is above the portable cluster size of 8
  cudaError_t err = cudaFuncSetAttribute(
      slstm_scan_kernel<kNB, kMode>,
      cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)(n_clusters * kC), 1, 1);
  cfg->blockDim = dim3(kThreads, 1, 1);
  cfg->dynamicSmemBytes = 0;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kC;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <int kNB, int kMode>
cudaError_t run(const Args& a, int n_clusters, cudaStream_t stream,
                int* max_clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<kNB, kMode>(&cfg, &attr, n_clusters, stream);
  if (err != cudaSuccess) return err;
  if (max_clusters)
    return cudaOccupancyMaxActiveClusters(
        max_clusters, slstm_scan_kernel<kNB, kMode>, &cfg);
  err = cudaLaunchKernelEx(&cfg, slstm_scan_kernel<kNB, kMode>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int kMode>
cudaError_t by_rows(const Args& a, int n_clusters, cudaStream_t stream,
                    int* max_clusters) {
  switch (a.rows) {
    case 1: return run<1, kMode>(a, n_clusters, stream, max_clusters);
    case 2: return run<2, kMode>(a, n_clusters, stream, max_clusters);
    case 3: return run<3, kMode>(a, n_clusters, stream, max_clusters);
    case 4: return run<4, kMode>(a, n_clusters, stream, max_clusters);
  }
  return cudaErrorInvalidValue;
}

// rows of a full group and clusters, as ops.slstm_geometry computes them
bool geometry(int B, int H, int* rows, int* n_clusters) {
  const int groups = (B + kMaxRows - 1) / kMaxRows;
  *rows = (B + groups - 1) / groups;
  if ((long long)H * groups * kC > 0x7fffffffLL) return false;
  *n_clusters = H * groups;
  return true;
}

cudaError_t call(const void* pre, const void* r, void* h, int B, int S,
                 int H, int P, const long long* strides, void* stream,
                 int mode, int* max_clusters) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || P > kMaxP)
    return cudaErrorInvalidValue;
  Args a;
  a.pre = static_cast<const float*>(pre);
  a.r = static_cast<const float*>(r);
  a.h = static_cast<float*>(h);
  a.B = B;
  a.S = S;
  a.H = H;
  a.P = P;
  int n_clusters;
  if (!geometry(B, H, &a.rows, &n_clusters)) return cudaErrorInvalidValue;
  for (int i = 0; i < 5; ++i) a.ps[i] = strides ? strides[i] : 0;
  for (int i = 0; i < 4; ++i) a.rs[i] = strides ? strides[5 + i] : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return by_rows<0>(a, n_clusters, st, max_clusters);
    case 1: return by_rows<1>(a, n_clusters, st, max_clusters);
    case 2: return by_rows<2>(a, n_clusters, st, max_clusters);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// How many clusters of the scan at batch B and head width P fit the card
// at once (0: it cannot run there).
extern "C" int slstm_scan_max_clusters(int B, int P, int* out) {
  *out = 0;
  return (int)call(nullptr, nullptr, nullptr, B, 1, 1, P, nullptr, nullptr,
                   0, out);
}

// strides: pre (b, s, g, h, p), r (g, h, p, q), in elements; h is written
// contiguous [B, S, H, P]
extern "C" int slstm_scan_f32(const void* pre, const void* r, void* h, int B,
                              int S, int H, int P, const long long* strides,
                              void* stream) {
  return (int)call(pre, r, h, B, S, H, P, strides, stream, 0, nullptr);
}

// The step floor: S steps of the h exchange alone (h_t = h_{t-1} + 1 per
// column), through st.async and mbarriers (mode 1) or DSMEM stores and a
// cluster barrier (mode 2); h receives the last step. Reads no pre or r.
extern "C" int slstm_step_floor_f32(void* h, int B, int S, int H, int P,
                                    int mode, void* stream) {
  if (mode != 1 && mode != 2) return (int)cudaErrorInvalidValue;
  return (int)call(nullptr, nullptr, h, B, S, H, P, nullptr, stream, mode,
                   nullptr);
}
