// encounter_mix for Hopper (sm_90a): the fused peer-encounter mix.
//
//   e[i, j] = (d2(i, j) <= r2) & area[i] == area[j] & active[i] & active[j]
//             & i != j
//   mass[i] = sum_j e[i, j]
//   mix[i]  = (sum_j e[i, j] * W[j]) / max(mass[i], 1e-12)
//
// pos [M, 2] f32, area [M] int64, active [M] uint8, W [M, D] f32 or bf16 ->
// mix [M, D] in W's type, mass [M] f32. The [M, M] matrix e is never stored.
//
// Replaces the Pallas TPU kernel src/repro/kernels/encounter_mix/kernel.py
// (_mix_kernel / encounter_mix_pallas), which builds one [block_m, M] strip
// of e per (row block, d block) tile and multiplies it on the MXU.
//
// What bounds it: the work is a product e[M, M] @ W[M, D]. Done densely it
// is M*M*D fp32 multiply-adds (71.6 GFLOP at M=256, D=546,484: 1.07 ms at
// 67 TFLOP/s outside the tensor cores) against 1.12 GB of bytes (W read
// once, mix written once: 0.33 ms at 3.35 TB/s), so a dense kernel is
// bound by operations. e is sparse in practice (a mule meets a few peers),
// so the least work the data needs is bytes-bound; skipping empty strips
// would reach for that and is later work.
//
// Design (simple and right first): a tiled fp32 matrix product whose left
// operand is generated on the fly.
// - Each block owns an output tile of kBM = 64 rows x kBN = 128 columns of
//   D; each of its 128 threads keeps an 8 x 8 register tile of sums.
// - The block walks the M visiting mules in chunks of kKC = 32. Per chunk
//   it stages the chunk's geometry, builds the 0/1 strip e[rows, chunk] in
//   shared memory (one row per builder thread, which also counts the row's
//   mass), and stages W[chunk, tile] with coalesced loads. The ragged M and
//   D edges are masked, never padded.
// - Row blocks of one column tile have neighbouring block indices, so they
//   run together and read that tile of W from L2 rather than from memory.
// - Sums are fp32 fused multiply-adds in the order j = 0 .. M-1; with
//   e in {0, 1} each step adds W[j] exactly rounded. No atomics, so a
//   replay is bitwise equal.
// - The gate is the plain version's bit for bit: d2 is
//   __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) (no contraction into a
//   fused multiply-add), r2 arrives already rounded to float32, area is
//   compared as integers, and self-exclusion uses global indices.
// - The epilogue divides by fmaxf(mass, 1e-12f) with IEEE division (no
//   --use_fast_math) and stores in W's type. Column block 0 writes mass.
// - The launch allocates nothing and returns cudaGetLastError().
// TF32 and the tensor cores are not used: parity is fp32. wgmma, TMA and
// skipping empty strips are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;        // output rows per block
constexpr int kBN = 128;       // output columns per block
constexpr int kKC = 32;        // visiting mules per chunk
constexpr int kTX = 16;        // threads along the columns
constexpr int kTY = 8;         // threads along the rows
constexpr int kThreads = kTX * kTY;
constexpr int kTM = kBM / kTY;  // 8 rows per thread, consecutive
constexpr int kTN = kBN / kTX;  // 8 columns per thread, kTX apart
static_assert(kBN == kThreads, "one W column per thread when staging");
static_assert(kKC <= kThreads, "one chunk mule per thread when staging");
static_assert(kTM == 8, "two float4 reads of the strip per step");

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    encounter_mix_kernel(const float* __restrict__ pos,
                         const int64_t* __restrict__ area,
                         const uint8_t* __restrict__ active,
                         const T* __restrict__ W, T* __restrict__ out,
                         float* __restrict__ mass_out, int M, int64_t D,
                         int n_row_blocks, float r2) {
  __shared__ __align__(16) float sE[kKC][kBM];  // sE[k][r] = e[row0+r, k0+k]
  __shared__ float sW[kKC][kBN];                // sW[k][c] = W[k0+k, col0+c]
  __shared__ float sX[kKC], sY[kKC];            // the chunk's geometry
  __shared__ int64_t sA[kKC];
  __shared__ int sOn[kKC];
  __shared__ float sMass[kBM];

  const int rb = (int)(blockIdx.x % (unsigned)n_row_blocks);
  const int64_t cb = blockIdx.x / (unsigned)n_row_blocks;
  const int row0 = rb * kBM;
  const int64_t col0 = cb * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;

  // builder threads (tid < kBM) own row row0 + tid of the strip
  const int my_row = row0 + tid;
  const bool builder = tid < kBM;
  float rx = 0.f, ry = 0.f;
  int64_t ra = 0;
  bool r_on = false;
  if (builder && my_row < M) {
    rx = pos[2 * (int64_t)my_row];
    ry = pos[2 * (int64_t)my_row + 1];
    ra = area[my_row];
    r_on = active[my_row] != 0;
  }
  float my_mass = 0.f;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  const int64_t my_col = col0 + tid;  // the column this thread stages
  for (int k0 = 0; k0 < M; k0 += kKC) {
    __syncthreads();  // every thread is done with the previous chunk
    if (tid < kKC) {
      const int c = k0 + tid;
      const bool in = c < M;
      sX[tid] = in ? pos[2 * (int64_t)c] : 0.f;
      sY[tid] = in ? pos[2 * (int64_t)c + 1] : 0.f;
      sA[tid] = in ? area[c] : 0;
      sOn[tid] = in && active[c] != 0;  // the ragged M edge is never met
    }
    // W[chunk, tile]: consecutive threads read consecutive columns
#pragma unroll 8
    for (int k = 0; k < kKC; ++k) {
      const int c = k0 + k;
      sW[k][tid] = (c < M && my_col < D)
                       ? load_f32(W + (int64_t)c * D + my_col)
                       : 0.f;
    }
    __syncthreads();
    if (builder) {
#pragma unroll 4
      for (int k = 0; k < kKC; ++k) {
        const float dx = __fsub_rn(rx, sX[k]);
        const float dy = __fsub_rn(ry, sY[k]);
        const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
        const bool met = r_on && sOn[k] && d2 <= r2 && ra == sA[k] &&
                         my_row != k0 + k;
        const float e = met ? 1.f : 0.f;
        sE[k][tid] = e;
        my_mass += e;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kKC; ++k) {
      const float4 e_lo = *reinterpret_cast<const float4*>(&sE[k][ty * kTM]);
      const float4 e_hi =
          *reinterpret_cast<const float4*>(&sE[k][ty * kTM + 4]);
      const float e[kTM] = {e_lo.x, e_lo.y, e_lo.z, e_lo.w,
                            e_hi.x, e_hi.y, e_hi.z, e_hi.w};
      float w[kTN];
#pragma unroll
      for (int j = 0; j < kTN; ++j) w[j] = sW[k][tx + kTX * j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(e[i], w[j], acc[i][j]);
    }
  }

  if (builder) {
    sMass[tid] = my_mass;
    if (cb == 0 && my_row < M) mass_out[my_row] = my_mass;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row0 + ty * kTM + i;
    if (r >= M) break;
    const float den = fmaxf(sMass[ty * kTM + i], 1e-12f);
    T* o = out + (int64_t)r * D;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int64_t col = col0 + tx + kTX * j;
      if (col < D) store_f32(o + col, acc[i][j] / den);
    }
  }
}

template <typename T>
int launch(const void* pos, const void* area, const void* active,
           const void* W, void* out, void* mass, int M, long long D, float r2,
           void* stream) {
  if (M < 1 || D < 0) return (int)cudaErrorInvalidValue;
  const int n_row_blocks = (M + kBM - 1) / kBM;
  // at least one column block, so that mass is written when D == 0
  const long long n_col_blocks = D > 0 ? (D + kBN - 1) / kBN : 1;
  const long long n_blocks = n_row_blocks * n_col_blocks;
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  encounter_mix_kernel<T><<<(unsigned)n_blocks, kThreads, 0, s>>>(
      static_cast<const float*>(pos), static_cast<const int64_t*>(area),
      static_cast<const uint8_t*>(active), static_cast<const T*>(W),
      static_cast<T*>(out), static_cast<float*>(mass), M, (int64_t)D,
      n_row_blocks, r2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int encounter_mix_f32(const void* pos, const void* area,
                                 const void* active, const void* W, void* out,
                                 void* mass, int M, long long D, float r2,
                                 void* stream) {
  return launch<float>(pos, area, active, W, out, mass, M, D, r2, stream);
}

extern "C" int encounter_mix_bf16(const void* pos, const void* area,
                                  const void* active, const void* W,
                                  void* out, void* mass, int M, long long D,
                                  float r2, void* stream) {
  return launch<__nv_bfloat16>(pos, area, active, W, out, mass, M, D, r2,
                               stream);
}
