// mule_agg for Hopper (sm_90a): out[F, D] = A[F, M] @ W[M, D].
//
// Replaces the Pallas TPU kernel src/repro/kernels/mule_agg/kernel.py
// (_agg_kernel / mule_agg_pallas): the dwell-weighted group mean of the
// flattened mule population at the F fixed devices.
//
// What bounds it: memory. Every element of W is read once and feeds F fused
// multiply-adds; in f32 a tile of at most 16 rows does at most 8 FLOP a
// byte, under the ~20 FLOP a byte at which the card's 67 TFLOP/s of FFMA
// would set the pace. The least time is the bytes of W (read once for each
// tile of rows) and of the output over the memory rate. Two things keep a
// plain kernel from it: the bytes it has in flight, which Little's law at
// 3.35 TB/s and ~1 us of latency puts at ~25 KB an SM, and the issue slots
// of its inner loop.
//
// Design:
// - Exact F. The kernel is instantiated for each tile height FT in 1..16, so
//   a tile of 12 rows does 12 rows of work. F > 16 is cut into
//   ceil(F / 16) tiles of FT = ceil(F / tiles) rows (gridDim.z); each tile
//   reads W again.
// - Register tiling over columns. A block of kThreads = 256 threads walks
//   strips of at most kC = 1,024 columns; a thread owns 4 consecutive
//   columns and keeps FT x 4 fp32 sums in registers. Per row of W it reads
//   its 4 values from shared memory once (16 bytes in f32, 8 in bf16) and
//   A's column for the row as float4 broadcasts, so each A value feeds 4
//   FMAs and each W value FT.
// - Bytes in flight that do not depend on registers. W comes into a ring of
//   kStages = 3 shared-memory stages of 48 KB (12 rows of 1,024 columns in
//   f32, 24 in bf16), two in flight while one is summed, one block an SM:
//   96 KB in flight an SM. Where D % 4 == 0 and W's base is 16-byte
//   aligned, each row of a stage is one 1-D bulk copy (cp.async.bulk,
//   completing on the stage's mbarrier) of the 16-byte-aligned window
//   around it; the row's values then start 0 or 8 bytes into its stage
//   row, which lets bf16 rows that are only 8-byte aligned (D = 546,484)
//   take bulk copies too. Every 16-byte piece copied holds some of W's
//   values, so nothing outside W's pages is read. Otherwise each thread
//   copies its own columns by cp.async in 8- or 4-byte granules, or (bf16
//   rows of an odd D) by plain loads.
// - A stays in shared memory, transposed to sA[m][FT rounded up to 4] and
//   zero past the tile's rows, in chunks of kAFloats floats (16 KB) whatever
//   M is, brought in by 4-byte cp.async all in flight at once; a chunk
//   boundary waits for the whole block.
// - A grid that fills the card. Blocks are persistent: one wave of resident
//   blocks shared by all (lane, row tile) pairs, gridDim.x of them a pair.
//   Strips of equal width, whole 4-column groups, tile D in order, and
//   block b walks strips b, b + gridDim.x, ..., the copies of its next
//   strip running on while one is summed. So all blocks read neighbouring
//   strips at about the same rows of W at once, as a wave of plain loads
//   would. At D = 546,484 and one lane a block takes five strips of 828
//   columns; at the LSTM-CNN's D = 44,580 one of 340, so every SM has work.
// - Fixed bits: each (f, d) is fmaf(A[f, m], W[m, d], acc) over m
//   ascending from +0, rounded once into W's type, whatever the grid. M
//   is never split, there are no atomics, so a replay is
//   bitwise and each lane is bitwise its single call.
// - Lanes (a seed sweep's S populations, mule_agg_lanes_*) are gridDim.y:
//   block row s offsets A, W and out by lane s's strides.
// - No tensor cores: wgmma takes 64 rows, 4-16x the rows a tile has, and a
//   3xTF32 split would change the bits of a pass that is bound by bytes.
// - The launch allocates nothing and returns cudaGetLastError(); the
//   occupancy and the shared-memory attribute are set once a kernel and
//   device, so that a launch can be captured in a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;           // 8 warps
constexpr int kVec = 4;                 // columns a thread
constexpr int kC = kThreads * kVec;     // columns a strip, at most
constexpr int kStageBytes = 49152;      // W a stage: kC columns x kK rows
constexpr int kStages = 3;              // the ring: kStages - 1 in flight
constexpr int kFMax = 16;               // rows of A a tile
constexpr int kAFloats = 4096;          // sA: 16 KB
constexpr int kMaxDevices = 64;

// rows of W a stage, and the bytes of a row of a stage: kC values and 16
// bytes of slack, since a row's bulk copy starts at the 16-byte boundary
// at or below its first value
template <typename T>
__host__ __device__ constexpr int rows_a_stage() {
  return kStageBytes / (kC * (int)sizeof(T));
}
template <typename T>
__host__ __device__ constexpr int row_bytes() {
  return kC * (int)sizeof(T) + 16;
}
template <typename T>
constexpr int smem_bytes() {
  return 128 + kAFloats * 4 + kStages * rows_a_stage<T>() * row_bytes<T>();
}

__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
// 4 consecutive values; p aligned to 4 elements
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&v)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&x.y));
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 x;
  x.x = *reinterpret_cast<const uint32_t*>(&a);
  x.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = x;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
               : "memory");
}

// The one arrival of a phase, which also tells the barrier how many bytes
// its copies bring.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Returns once the phase of the given parity has completed; a copy that
// never lands traps after ~4M tries instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 22)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16) from src to dst, both 16-byte aligned,
// completing on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// (start, bytes) of the 16-byte-aligned window around n values from p
template <typename T>
__device__ __forceinline__ ulonglong2 window(const T* p, int64_t n) {
  const unsigned long long a = reinterpret_cast<uintptr_t>(p);
  const unsigned long long lo = a & ~15ull;
  return make_ulonglong2(lo, ((a + n * sizeof(T) + 15) & ~15ull) - lo);
}

// cp.async of N bytes
template <int N>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(dst),
               "l"(src), "n"(N)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// How W's stages reach shared memory (see the note at the top).
enum Load { kLoadBulk = 0, kLoadAsync = 1, kLoadSync = 2 };

// One (lane, row tile) per (blockIdx.y, blockIdx.z), gridDim.x blocks a
// pair, each walking every gridDim.x-th strip of D. Tile z holds rows
// z FT .. min(F, (z + 1) FT) - 1 of A and out.
template <int FT, typename T>
__global__ void __launch_bounds__(kThreads)
    mule_agg_kernel(const float* __restrict__ A, const T* __restrict__ W,
                    T* __restrict__ out, int F, int M, int64_t D, int load,
                    int granule, int vec_out) {
  constexpr int kK = rows_a_stage<T>();
  constexpr int kRow = row_bytes<T>();
  constexpr int kFp = (FT + 3) / 4 * 4;                // sA's row pitch
  constexpr int kMC = kAFloats / kFp / kK * kK;        // rows of A a chunk
  static_assert(kMC >= kK, "a chunk of A holds a stage's rows");
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // [kStages]
  float* sA = reinterpret_cast<float*>(smem + 128);    // [kMC][kFp]
  unsigned char* sW = smem + 128 + kAFloats * 4;       // [kStages][kK] rows

  const int tid = threadIdx.x;
  const int64_t lane = blockIdx.y;
  const int f0 = blockIdx.z * FT;
  const int rows = min(FT, F - f0);
  A += (lane * F + f0) * (int64_t)M;
  W += lane * M * D;
  out += (lane * F + f0) * D;

  // strips of sw columns (whole 4-column groups) tile D in order; block b
  // takes strips b, b + gridDim.x, ..., so that the blocks walk
  // neighbouring strips, at about the same rows of W, together
  const int64_t n_vec = (D + kVec - 1) / kVec;
  const int64_t grid_vecs = (int64_t)gridDim.x * (kC / kVec);
  const int64_t per_block = (n_vec + grid_vecs - 1) / grid_vecs;
  const int64_t sw = (n_vec + gridDim.x * per_block - 1) /
                     (gridDim.x * per_block) * kVec;
  const int64_t stride = (int64_t)gridDim.x * sw;
  const int64_t c_begin = blockIdx.x * sw;
  const int64_t n_strips = c_begin < D ? (D - c_begin + stride - 1) / stride
                                       : 0;
  const int n_k = (M + kK - 1) / kK;  // stages a strip
  const int64_t n_iter = n_strips * n_k;

  // where the bulk copy of row m at column c starts in its stage row: the
  // bytes from the 16-byte boundary below it (0 for 16-byte aligned rows)
  auto shift = [&](int64_t m, int64_t c) -> int {
    return load == kLoadBulk
               ? (int)(reinterpret_cast<uintptr_t>(W + m * D + c) & 15u)
               : 0;
  };
  // the producer's cursor: stage p_k of the strip at p_c0 into ring slot p_s
  int64_t p_t = 0, p_c0 = c_begin;
  int p_k = 0, p_s = 0;
  auto produce = [&]() {
    if (p_t < n_iter) {
      const int m0 = p_k * kK, kn = min(kK, M - m0);
      const int64_t seg = D - p_c0 < sw ? D - p_c0 : sw;  // columns
      unsigned char* dst = sW + p_s * kK * kRow;
      const T* src = W + (int64_t)m0 * D + p_c0;
      if (load == kLoadBulk) {
        // each row's 16-byte-aligned window (see the note at the top)
        if (tid == 0) {
          const uint32_t bar = smem_addr(&bars[p_s]);
          uint32_t total = 0;
          for (int r = 0; r < kn; ++r) total += window(src + r * D, seg).y;
          mbar_expect(bar, total);
          for (int r = 0; r < kn; ++r) {
            const ulonglong2 w = window(src + r * D, seg);
            bulk_load(smem_addr(dst + r * kRow),
                      reinterpret_cast<const void*>(w.x), (uint32_t)w.y, bar);
          }
        }
      } else {  // this thread's own 4 columns of each row
        const int e0 = tid * kVec;
        const int elems = load == kLoadSync ? 1 : granule / (int)sizeof(T);
        for (int r = 0; r < kn; ++r) {
          T* drow = reinterpret_cast<T*>(dst + r * kRow);
          for (int e = e0; e < e0 + kVec && e < seg; e += elems) {
            if (load == kLoadAsync) {
              const uint32_t d = smem_addr(drow + e);
              if (granule == 8)
                cp_async<8>(d, src + r * D + e);
              else
                cp_async<4>(d, src + r * D + e);
            } else {
              drow[e] = src[r * D + e];
            }
          }
        }
      }
    }
    // the cp.async path: one group a stage, empty ones past the last
    if (load == kLoadAsync) cp_commit();
    ++p_t;
    if (++p_k == n_k) p_k = 0, p_c0 += stride;
    if (++p_s == kStages) p_s = 0;
  };
  // rows [m0, m0 + mc) of the tile's A into sA, transposed, zero past its
  // rows: 4-byte copies, all in flight at once, then one wait (which also
  // waits for the W copies of the cp.async path)
  auto load_a = [&](int m0, int mc) {
    for (int i = tid; i < kFp * mc; i += kThreads) {
      const int f = i / mc, j = i - f * mc;
      float* d = sA + j * kFp + f;
      if (f < rows)
        cp_async<4>(smem_addr(d), A + (int64_t)f * M + m0 + j);
      else
        *d = 0.f;
    }
    cp_commit();
    cp_wait<0>();
  };

  if (load == kLoadBulk && tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(smem_addr(&bars[s]));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = 0; i < kStages - 1; ++i) produce();
  const bool a_chunks = M > kMC;  // else sA holds all of A from here on
  if (!a_chunks) load_a(0, M);

  float acc[FT][kVec];
#pragma unroll
  for (int f = 0; f < FT; ++f)
#pragma unroll
    for (int x = 0; x < kVec; ++x) acc[f][x] = 0.f;
  int64_t c0 = c_begin;
  int k = 0, s = 0, a_m0 = 0;
  uint32_t phase = 0;

  for (int64_t t = 0; t < n_iter; ++t) {
    const int m0 = k * kK, kn = min(kK, M - m0);
    if (load == kLoadAsync) cp_wait<kStages - 2>();  // stage t has landed
    __syncthreads();  // stage t - 1 is summed: its slot (and sA) are free
    if (a_chunks && m0 % kMC == 0) {
      a_m0 = m0;
      load_a(m0, min(kMC, M - m0));
      __syncthreads();
    }
    produce();  // stage t + kStages - 1, into stage t - 1's slot
    if (load == kLoadBulk) mbar_wait(smem_addr(&bars[s]), phase);
    // the other paths' columns are this thread's own copies: no wait

    const unsigned char* st = sW + s * kK * kRow + tid * kVec * sizeof(T);
    const float* sa = sA + (m0 - a_m0) * kFp;
    auto row = [&](int r) {
      float w[kVec];
      load4(reinterpret_cast<const T*>(st + r * kRow + shift(m0 + r, c0)), w);
#pragma unroll
      for (int f4 = 0; f4 < kFp; f4 += 4) {
        const float4 a4 = *reinterpret_cast<const float4*>(sa + r * kFp + f4);
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (f4 + q < FT)
#pragma unroll
            for (int x = 0; x < kVec; ++x)
              acc[f4 + q][x] = fmaf(a[q], w[x], acc[f4 + q][x]);
      }
    };
    if (kn == kK) {
#pragma unroll
      for (int r = 0; r < kK; ++r) row(r);
    } else {
      for (int r = 0; r < kn; ++r) row(r);
    }

    if (k == n_k - 1) {  // the strip is summed: store and start over
      const int64_t col = c0 + tid * kVec;
      const int64_t end = c0 + sw < D ? c0 + sw : D;
#pragma unroll
      for (int f = 0; f < FT; ++f) {
        if (f < rows && col < end) {
          T* o = out + (int64_t)f * D + col;
          if (vec_out && col + kVec <= end) {
            store4(o, acc[f]);
          } else {
#pragma unroll
            for (int x = 0; x < kVec; ++x)
              if (col + x < end) store_f32(o + x, acc[f][x]);
          }
        }
#pragma unroll
        for (int x = 0; x < kVec; ++x) acc[f][x] = 0.f;
      }
    }
    if (++k == n_k) k = 0, c0 += stride;
    if (++s == kStages) s = 0, phase ^= 1u;
  }
  if (load == kLoadAsync) cp_wait<0>();  // no copy outlives the block
}

// The persistent wave of one instantiation on the current device: its
// resident blocks an SM times the SMs, after its shared memory is allowed.
// Computed once a device, so that a launch makes no attribute calls and
// can be captured in a CUDA graph.
template <int FT, typename T>
int wave(int* blocks) {
  static int cached[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < kMaxDevices && cached[dev] > 0) {
    *blocks = cached[dev];
    return 0;
  }
  auto kern = mule_agg_kernel<FT, T>;
  constexpr int bytes = smem_bytes<T>();
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  int sms = 0, occ = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, kThreads,
                                                      bytes);
  if (err != cudaSuccess) return (int)err;
  if (occ < 1) return (int)cudaErrorInvalidConfiguration;
  *blocks = sms * occ;
  if (dev < kMaxDevices) cached[dev] = *blocks;
  return 0;
}

template <int FT, typename T>
int launch_ft(const float* A, const T* W, T* out, int S, int F, int M,
              long long D, int tiles, int grid_blocks, cudaStream_t stream) {
  int blocks = 0;
  const int err = wave<FT, T>(&blocks);
  if (err != 0) return err;
  if (grid_blocks > 0) blocks = grid_blocks;  // a tuned grid (autotune.py)
  // one wave of resident blocks (or grid_blocks) for all (lane, tile)
  // pairs, each pair an equal share of it, every block at least 4 columns
  const long long n_vec = (D + kVec - 1) / kVec;
  const long long pairs = (long long)S * tiles;
  long long gx = (blocks + pairs - 1) / pairs;
  if (gx > n_vec) gx = n_vec;
  const dim3 grid((unsigned)gx, (unsigned)S, (unsigned)tiles);
  // the widest copy W's rows allow: bulk copies where W's base is 16-byte
  // aligned and each strip's first value in a row is aligned to 4 values
  // (D % 4 == 0: 16 bytes in f32, 8 in bf16)
  const uintptr_t w_addr = reinterpret_cast<uintptr_t>(W);
  const long long pitch = D * (long long)sizeof(T);
  int load = kLoadSync, granule = 0;
  if (D % kVec == 0 && w_addr % 16 == 0) {
    load = kLoadBulk;
  } else {
    for (int g = 8; g >= 4 && load == kLoadSync; g /= 2)
      if (pitch % g == 0 && w_addr % g == 0) load = kLoadAsync, granule = g;
  }
  const uintptr_t o_addr = reinterpret_cast<uintptr_t>(out);
  const int vec_out = D % kVec == 0 && o_addr % (kVec * sizeof(T)) == 0;
  mule_agg_kernel<FT, T><<<grid, kThreads, smem_bytes<T>(), stream>>>(
      A, W, out, F, M, (int64_t)D, load, granule, vec_out);
  return (int)cudaGetLastError();
}

// ceil(F / 16) row tiles of equal height FT <= 16, none empty
int tile_height(int F) {
  const int tiles0 = (F + kFMax - 1) / kFMax;
  return (F + tiles0 - 1) / tiles0;
}

template <typename T>
int launch(const void* A, const void* W, void* out, int S, int F, int M,
           long long D, int grid_blocks, void* stream) {
  if (S < 1 || S > 65535 || F < 1 || M < 1 || D < 1 || grid_blocks < 0)
    return (int)cudaErrorInvalidValue;
  const int ft = tile_height(F);
  const int tiles = (F + ft - 1) / ft;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;  // gridDim.z
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(A);
  const T* w = static_cast<const T*>(W);
  T* o = static_cast<T*>(out);
  switch (ft) {
#define MULE_AGG_FT(n) \
  case n:              \
    return launch_ft<n, T>(a, w, o, S, F, M, D, tiles, grid_blocks, s);
    MULE_AGG_FT(1) MULE_AGG_FT(2) MULE_AGG_FT(3) MULE_AGG_FT(4)
    MULE_AGG_FT(5) MULE_AGG_FT(6) MULE_AGG_FT(7) MULE_AGG_FT(8)
    MULE_AGG_FT(9) MULE_AGG_FT(10) MULE_AGG_FT(11) MULE_AGG_FT(12)
    MULE_AGG_FT(13) MULE_AGG_FT(14) MULE_AGG_FT(15) MULE_AGG_FT(16)
#undef MULE_AGG_FT
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int wave_of(int F, int* blocks) {
  if (F < 1) return (int)cudaErrorInvalidValue;
  switch (tile_height(F)) {
#define MULE_AGG_FT(n) \
  case n:              \
    return wave<n, T>(blocks);
    MULE_AGG_FT(1) MULE_AGG_FT(2) MULE_AGG_FT(3) MULE_AGG_FT(4)
    MULE_AGG_FT(5) MULE_AGG_FT(6) MULE_AGG_FT(7) MULE_AGG_FT(8)
    MULE_AGG_FT(9) MULE_AGG_FT(10) MULE_AGG_FT(11) MULE_AGG_FT(12)
    MULE_AGG_FT(13) MULE_AGG_FT(14) MULE_AGG_FT(15) MULE_AGG_FT(16)
#undef MULE_AGG_FT
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// S lanes in one launch (S = 1: a single call): A [S, F, M], W [S, M, D]
// -> out [S, F, D]. grid_blocks: the blocks shared by all (lane, row tile)
// pairs, 0 for one persistent wave (mule_agg_wave_blocks); the bits do not
// depend on it.
extern "C" int mule_agg_lanes_f32(const void* A, const void* W, void* out,
                                  int S, int F, int M, long long D,
                                  int grid_blocks, void* stream) {
  return launch<float>(A, W, out, S, F, M, D, grid_blocks, stream);
}

extern "C" int mule_agg_lanes_bf16(const void* A, const void* W, void* out,
                                   int S, int F, int M, long long D,
                                   int grid_blocks, void* stream) {
  return launch<__nv_bfloat16>(A, W, out, S, F, M, D, grid_blocks, stream);
}

// The blocks of one persistent wave of the instance that runs F rows, in W's
// type (bf16 != 0: bfloat16), on the current device.
extern "C" int mule_agg_wave_blocks(int F, int bf16, int* blocks) {
  return bf16 ? wave_of<__nv_bfloat16>(F, blocks) : wave_of<float>(F, blocks);
}
