// flash_attention on Hopper's tensor cores (sm_90a): the bf16 route of
// out = softmax(scale * q k^T + mask) v for head dims 64, 80, 128 and 256.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_attn_kernel / flash_attention_pallas), as csrc/flash_attention.cu does;
// that SIMT kernel stays for float32 (every head dim) and for bf16 at head
// dims 8, 16 and 32. It computes what _attn_kernel computes: right-aligned
// queries (query i sits at position i + Sk - S), a causal mask and a
// sliding window, GQA through h / (H / KV) without repeating KV heads, an
// online softmax, -1e30 for masked scores and a final division by
// max(l, 1e-30).
//
// What bounds it: operations. A (q, k) pair costs 4 D FLOP against a few
// bytes, so at the models' shapes the least time is the unmasked pairs'
// FLOP over the bf16 tensor-core peak (989 TFLOP/s dense). The SIMT kernel
// ran them as fp32 FMAs on the CUDA cores (67 TFLOP/s); this one runs both
// products on the tensor cores with wgmma, fp32 accumulation.
//
// Precision. The reference computes in fp32 and rounds the output once.
// - q k^T: a bf16 x bf16 product is exact in fp32, so wgmma with fp32
//   accumulation gives the reference's scores on the same inputs, summed in
//   another order. The scale (times log2 e, for exp2) is applied to the
//   fp32 scores; q is not pre-scaled in bf16 (1/sqrt(80) is no bf16
//   number).
// - p v: rounding p to one bf16 costs up to 2^-9 of each term, which is
//   more than the output's bound (half a bf16 ulp of the fp32 result) where
//   v's signs cancel. So p is split, p_hi = bf16(p) and p_lo = bf16(p -
//   p_hi) (the difference is exact in fp32), and both go through wgmma into
//   the one fp32 accumulator: ~2^-18 of each term is left. That is 1.5x the
//   useful tensor-core work. The row sum l is the fp32 sum of p.
//
// Design (one warpgroup per block; simple before fast):
// - A block of 128 threads (one warpgroup) takes 64 queries of one (b, h)
//   and walks the key blocks of 64 that they need: blocks outside
//   [q_start - window, q_start + 64) are skipped by the loop bounds, and
//   per-pair masks are applied only on blocks that straddle the diagonal,
//   the window's edge or Sk. The grid is (B * H, query tiles), tiles issued
//   last-first, so the longest causal rows start first.
// - Loads are TMA (cp.async.bulk.tensor) into 128-byte-swizzled shared
//   memory, completing on mbarriers. One tensor map per operand reads the
//   strided [B, S, H, D] view in place (dims D, H, S, B); a 16-byte-aligned
//   base and strides that are multiples of 16 bytes are required, and the
//   wrapper checks them before the launch. TMA fills rows at or past S (q)
//   and Sk (k, v) with zeros; the store masks rows >= S.
// - Shared memory: q, k and v tiles of 64 rows x D, each as D/64 chunks of
//   64 rows x 128 bytes (the swizzle atom's width). D = 80 is padded in
//   shared memory to two chunks, 64 + 16 columns with 48 columns of TMA zero
//   fill: the tiles take 16 KB instead of 10 KB, the loads move 60% more
//   bytes between L2 and shared memory (the zeros are made by TMA, not read
//   from device memory), and the products never read the padding
//   (q k^T runs 5 k-steps of 16, p v is m64n80k16). Total 3 x 8 KB x
//   ceil(D/64) + 1 KB of alignment slack: 97 KB at D = 256, so two blocks
//   fit an SM; 49 KB at D = 80 and 128.
// - k and v have one buffer each and their own mbarrier. Thread 0 issues
//   the load of key block j + 1 into the k buffer as soon as every warp is
//   done with q k_j^T, and into the v buffer as soon as p v_j is done, so
//   each load overlaps the softmax and the other product. With two or more
//   blocks on an SM, one block's softmax also overlaps another's wgmma.
// - q k^T: wgmma m64n64k16, both operands K-major from shared memory.
// - Softmax in registers: each row's 64 scores sit in the four lanes of a
//   quad (the accumulator layout), so its max takes two shuffles; each
//   thread keeps a partial row sum and the quad adds them once at the end.
//   A fully masked row of a visited block keeps m = -1e30 and accumulates
//   exp2(0) = 1 per masked key as garbage, which the next block's
//   correction exp2(-1e30 - m) = 0 wipes out, as in the SIMT kernel.
// - p v: the accumulator of q k^T is, fragment for fragment, the A
//   operand of the next wgmma (A from registers), so p_hi and p_lo never
//   touch shared memory. B = v [64 keys, D] as loaded, N-major (wgmma's
//   transpose flag; legal for 16-bit types), m64nDk16 into an fp32
//   accumulator of D/2 registers a thread (128 at D = 256).
// - No producer warp and no setmaxnreg: all 128 threads need the same
//   registers (~D/2 + 64), and the one-warpgroup block leaves them 255.
// - The epilogue divides by max(l, 1e-30) in fp32, rounds once to bf16 and
//   stores into a new contiguous [B, S, H, D].
//
// The tensor maps are encoded on the host with cuTensorMapEncodeTiled,
// taken from the driver through the runtime's entry-point query
// (cudaGetDriverEntryPointByVersion), so the library links nothing beyond
// the CUDA runtime. The launch allocates
// nothing and returns cudaGetLastError(), or kErrEncode + the driver's
// code when a tensor map cannot be encoded, or kErrEntryPoint when the
// driver has no cuTensorMapEncodeTiled.

#include <cuda.h>          // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;        // one warpgroup
constexpr int BQ = 64;               // queries per block (wgmma's M)
constexpr int BK = 64;               // keys per step of the loop
constexpr int kChunkCols = 64;       // bf16 columns in a 128-byte row
constexpr int kChunkBytes = 64 * 128;   // 64 rows x 128 bytes
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kErrEncode = 10000;
constexpr int kErrEntryPoint = 20000;

template <int D>
struct Tile {
  static constexpr int kChunks = (D + kChunkCols - 1) / kChunkCols;
  static constexpr int kBytes = kChunks * kChunkBytes;   // one operand
  static constexpr int kSmem = 3 * kBytes + 1024;        // q, k, v + slack
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
               : "memory");
}

// One arrival (thread 0's) that also tells the barrier how many bytes the
// TMA loads of this phase will bring.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Returns once the phase of the given parity has completed. A load that
// never lands (a bad tensor map) traps after ~4M tries instead of hanging
// the card.
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

// 64 rows x 64 columns of one (b, head) at column c0, row r0, 128-byte
// swizzled, into dst; completes on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int head,
                                         int r0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(head),
      "r"(r0), "r"(b)
      : "memory");
}

template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int head, int r0,
                                          int b) {
  mbar_expect(bar, Tile<D>::kBytes);
#pragma unroll
  for (int c = 0; c < Tile<D>::kChunks; ++c)
    tma_load(dst + c * kChunkBytes, map, bar, c * kChunkCols, head, r0, b);
}

// wgmma's shared-memory matrix descriptor, 128-byte swizzle: the start
// address, the leading and the stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)lbo << 16) |
         ((uint64_t)sbo << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// After wgmma_wait_all: the compiler must neither read an accumulator nor
// reuse an A-operand register before this point.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// (x, y) -> bf16x2 of the rounded pair and of the rounding residual.
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// ---- wgmma, bf16 x bf16 -> fp32 (PTX ISA, wgmma.mma_async) ----
// d[0..32) += A(smem) B(smem), m64n64k16, both operands K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d[0..32) += A(registers) B(smem), m64n64k16, B N-major (transposed).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[0..40) += A(registers) B(smem), m64n80k16, B N-major (transposed).
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[0..64) += A(registers) B(smem), m64n128k16, B N-major (transposed).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[0..128) += A(registers) B(smem), m64n256k16, B N-major (transposed).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 64) {
    wgmma_rs_n64(o, a, db);
  } else if constexpr (D == 80) {
    wgmma_rs_n80(o, a, db);
  } else if constexpr (D == 128) {
    wgmma_rs_n128(o, a, db);
  } else {
    static_assert(D == 256, "head dims 64, 80, 128, 256");
    wgmma_rs_n256(o, a, db);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              __nv_bfloat16* __restrict__ out, int S, int Sk,
                              int H, int KV, float scale_log2, int causal,
                              int window) {
  constexpr int NO = D / 2;   // accumulator floats a thread
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[3];
  // the swizzle is a function of the address, so each chunk starts on a
  // 1024-byte boundary
  const uint32_t sq = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = sq + Tile<D>::kBytes;
  const uint32_t sv = sk + Tile<D>::kBytes;
  const uint32_t bar_q = smem_addr(&bars[0]);
  const uint32_t bar_k = smem_addr(&bars[1]);
  const uint32_t bar_v = smem_addr(&bars[2]);

  const int b = (int)blockIdx.x / H, h = (int)blockIdx.x % H;
  const int kvh = h / (H / KV);
  const int nq = (S + BQ - 1) / BQ;
  const int row0 = (nq - 1 - (int)blockIdx.y) * BQ;
  const int q_start = row0 + Sk - S;   // position of the tile's first query

  // key blocks the tile needs, as in the SIMT kernel: k_start < q_start +
  // BQ (causal) and k_start + BK > q_start - window (window)
  const int nk = (Sk + BK - 1) / BK;
  int hi = nk;
  if (causal) {
    const int need = q_start + BQ;
    hi = need <= 0 ? 0 : min(nk, (need + BK - 1) / BK);
  }
  int lo = 0;
  if (window > 0) {
    const int t = q_start - window - BK;
    lo = t < 0 ? 0 : t / BK + 1;
  }

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_q);
    mbar_init(bar_k);
    mbar_init(bar_v);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && lo < hi) {
    load_tile<D>(sq, &tm_q, bar_q, h, row0, b);
    load_tile<D>(sk, &tm_k, bar_k, kvh, lo * BK, b);
    load_tile<D>(sv, &tm_v, bar_v, kvh, lo * BK, b);
  }

  // the accumulator layout: warp w holds rows 16 w .. 16 w + 15; a thread
  // holds rows r_lo and r_lo + 8, columns 8 n + c_lo + {0, 1}, at index
  // 4 n + 2 (row half) + (column parity)
  const int warp = tid / 32, lane = tid % 32;
  const int r_lo = warp * 16 + lane / 4;
  const int c_lo = (lane % 4) * 2;

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  if (lo < hi) mbar_wait(bar_q, 0);

  for (int kj = lo; kj < hi; ++kj) {
    const uint32_t parity = (uint32_t)(kj - lo) & 1u;
    const int k_start = kj * BK;

    // s = q k^T: D / 16 steps of m64n64k16 (at D = 80 the fifth reads the
    // first 16 columns of the padded chunk)
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    mbar_wait(bar_k, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kChunkBytes + (kk % 4) * 32;
      wgmma_ss_n64(s, sw128_desc(sq + off, 1, 64),
                   sw128_desc(sk + off, 1, 64));
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(s);
    __syncthreads();   // every warp is done reading the k buffer
    if (tid == 0 && kj + 1 < hi)
      load_tile<D>(sk, &tm_k, bar_k, kvh, k_start + BK, b);

    // scale (log2 domain), then mask the edge blocks pair by pair
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= scale_log2;
    const bool edge = k_start + BK > Sk ||
                      (causal && k_start + BK - 1 > q_start) ||
                      (window > 0 && k_start <= q_start + BQ - 1 - window);
    if (edge) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int qpos = q_start + r_lo + ((i >> 1) & 1) * 8;
        const int kpos = k_start + (i >> 2) * 8 + c_lo + (i & 1);
        bool ok = kpos < Sk;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        if (!ok) s[i] = kNegInf;
      }
    }

    // online softmax; a row's 64 scores sit in the 4 lanes of a quad
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2_approx(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = exp2_approx(s[i] - m[r]);
      l[r] += s[i];
    }
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= corr[(i >> 1) & 1];

    // p as the A operand of p v, split into bf16 hi + lo: k-step kk takes
    // keys 16 kk .. 16 kk + 15, the accumulator's indices 8 kk .. 8 kk + 7
    uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        split_bf16x2(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1], p_hi[kk][j],
                     p_lo[kk][j]);

    // o += p_hi v + p_lo v; v [64 keys, D] is N-major: 8 key rows of 128
    // bytes a core group (SBO 1024 B), 64-column chunks 8 KB apart (LBO)
    mbar_wait(bar_v, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = sw128_desc(sv + kk * 16 * 128, kChunkBytes >> 4, 64);
      wgmma_pv<D>(o, p_hi[kk], dv);
      wgmma_pv<D>(o, p_lo[kk], dv);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(o);
    reg_fence(p_hi);
    reg_fence(p_lo);
    __syncthreads();   // every warp is done reading the v buffer
    if (tid == 0 && kj + 1 < hi)
      load_tile<D>(sv, &tm_v, bar_v, kvh, k_start + BK, b);
  }

  // epilogue: the quad's partial row sums, o / max(l, 1e-30), one rounding
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r_lo + 8 * r;
    if (row >= S) continue;
    __nv_bfloat16* dst = out + (((int64_t)b * S + row) * H + h) * D + c_lo;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) = __floats2bfloat162_rn(
          o[4 * n + 2 * r] / l[r], o[4 * n + 2 * r + 1] / l[r]);
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A [batch, rows, heads, D] bf16 view (strides in elements) as a 4-d tensor
// map (D, heads, rows, batch) whose box is 64 columns x 1 head x 64 rows,
// 128-byte swizzled; out-of-bounds elements read as zeros.
int encode(CUtensorMap* map, EncodeTiledFn fn, const void* ptr, int D,
           int rows, int heads, int batch, long long sb, long long ss,
           long long sh) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kChunkCols, 1, (cuuint32_t)BQ, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kErrEncode + (int)res;
}

template <int D>
int launch_d(const CUtensorMap& mq, const CUtensorMap& mk,
             const CUtensorMap& mv, __nv_bfloat16* out, int B, int S, int Sk,
             int H, int KV, float scale, int causal, int window,
             cudaStream_t stream) {
  auto kern = flash_attention_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<D>::kSmem);
  if (err != cudaSuccess) return (int)err;
  // the whole carveout as shared memory, so that two blocks fit at D = 256
  err = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * H), (unsigned)((S + BQ - 1) / BQ));
  kern<<<grid, kThreads, Tile<D>::kSmem, stream>>>(
      mq, mk, mv, out, S, Sk, H, KV, scale * kLog2e, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, S, H, D], k and v [B, Sk, KV, D], bf16; strides: q (b, s, h),
// k (b, s, h), v (b, s, h), in elements, each a multiple of 8 (16 bytes),
// and 16-byte-aligned bases; D one of 64, 80, 128, 256; window < 1 means
// none. out is a new contiguous [B, S, H, D].
extern "C" int flash_attention_bf16_tc(const void* q, const void* k,
                                       const void* v, void* out, int B,
                                       int S, int Sk, int H, int KV, int D,
                                       const long long* st, float scale,
                                       int causal, int window, void* stream) {
  if (B < 1 || S < 1 || Sk < 1 || H < 1 || KV < 1 || H % KV != 0 ||
      (long long)B * H > 0x7fffffffLL || (S + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 9; ++i)
    if (st[i] % 8 != 0) return (int)cudaErrorInvalidValue;
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kErrEntryPoint;
  CUtensorMap mq, mk, mv;
  int err = encode(&mq, fn, q, D, S, H, B, st[0], st[1], st[2]);
  if (err == 0) err = encode(&mk, fn, k, D, Sk, KV, B, st[3], st[4], st[5]);
  if (err == 0) err = encode(&mv, fn, v, D, Sk, KV, B, st[6], st[7], st[8]);
  if (err != 0) return err;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_d<64>(mq, mk, mv, o, B, S, Sk, H, KV, scale, causal,
                          window, s);
    case 80:
      return launch_d<80>(mq, mk, mv, o, B, S, Sk, H, KV, scale, causal,
                          window, s);
    case 128:
      return launch_d<128>(mq, mk, mv, o, B, S, Sk, H, KV, scale, causal,
                           window, s);
    case 256:
      return launch_d<256>(mq, mk, mv, o, B, S, Sk, H, KV, scale, causal,
                           window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
