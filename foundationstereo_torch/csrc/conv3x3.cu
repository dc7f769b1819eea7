// 3x3 convolution, stride 1, zero padding 1, fp32 accumulation (K4).
//
// Replaces the TPU kernel foundationstereo_tpu/ops/conv3x3.py:conv3x3_pallas
// (body _rows_kernel), which evaluates the conv as 9 shifted (pixels, C) @
// (C, F) dots per block of rows with the weights resident in VMEM:
//
//   out[n, f, y, x] = bias[f] + sum_{c, dy, dx} in[n, c, y+dy-1, x+dx-1] * w[f, c, dy, dx]
//
// with in[...] = 0 outside the image. Layout here is channel-first: the input
// is NCHW (or a (B, C, D, H, W) volume with D folded into the batch: the
// wrapper passes an outer and an inner batch stride and a channel stride, so
// no copy is made), the output the same, H and W contiguous.
//
// Bound on the H100: operations. The refinement loop's largest conv (gru04
// 512 -> 512 at 184 x 320) is 2*9*512*512*58880 = 278 GFLOP against ~125 MB
// of input, weights and output (~2200 FLOP per byte, far above the card's
// ~295), so the tensor cores are the limit and the design is an implicit GEMM
// on them: M = output pixels, N = F, K = 9*C.
//
// bf16 (the main path): wgmma fed by an asynchronous shared-memory ring, in
// three warpgroups per block.
// - A block owns 2R output rows x 64 columns of one image and BN output
//   channels: BN = 128, or 64 where F <= 64; R = 2, or 1 where the wrapper
//   finds that the smaller tile fills the card better (the 1/16 level, the
//   hourglass). Each of the two consumer warpgroups owns R of the rows and
//   issues, per 16-channel K step, R wgmma.mma_async m64nBNk16 (bf16 in, fp32
//   accumulators in registers).
// - K walks C in chunks of 64 channels, chunk outer, tap inner. Warps 1-3 of
//   the producer warpgroup stage a chunk's haloed (2R + 2) x 66 input patch,
//   read from NCHW with 16-byte loads along x (8 pixels of one channel,
//   transposed in registers; 2-byte loads where the alignment does not allow
//   them; the padding ring and ragged C are predicated zero fills), and
//   stored pixel-major as wgmma's K-major core matrices:
//   [8-channel group][pixel][8 channels], 16 bytes per pixel, no swizzle. A tap
//   (dy, dx) is then an A descriptor whose start moves by (dy * 66 + dx) * 16
//   bytes, so the 9 taps read one patch and the input leaves device memory
//   once per (chunk, N block). The patch is double-buffered on full/empty
//   mbarriers: chunk c + 1 loads while chunk c computes.
// - The weights stream through a ring of kStages (chunk, tap) tiles.
//   pack_conv3x3_weight stores each BN x 64 tile contiguously in the exact
//   shared-memory image wgmma's B descriptor reads (K-major, 128-byte swizzle),
//   and producer warp 0 moves it with one 1-D bulk copy (cp.async.bulk,
//   completing on the stage's full mbarrier). The consumers release a stage one
//   K step after it was issued (wgmma.wait_group 1), so the tensor cores always
//   have the next step queued.
// - Epilogue: bias in fp32, one rounding to bf16, staged through shared memory
//   so that each warp stores whole 64-pixel rows of one channel (predicated on
//   ragged W and F).
//
// fp32 (the model without mixed precision): the same plan on TF32 wgmma in
// three passes (tf32x3.cuh), held to the fp32 tolerance. What changes for
// 4-byte elements:
// - A core matrix is 8 pixels x 4 channels, so the patch is [4-channel
//   group][pixel][4 channels], chunks of 16 channels, and a tap still moves
//   A's start by (dy * 66 + dx) * 16 bytes. Warps 1-3 split each value into
//   tf32 hi and lo as they stage it (4 pixels of a channel per 16-byte load,
//   transposed in registers) and write a hi and a lo image of the patch.
// - pack_conv3x3_weight(w, float32) packs each (chunk, tap) tile as its hi
//   then its lo image, [4-channel group][BN rows][4 channels], the layout the
//   B descriptor reads (no swizzle); one bulk copy moves both.
// - Per tap, each 8-channel K step is three wgmma m64nBNk8 (lo * hi, hi * lo,
//   then hi * hi) into a partial accumulator that starts fresh at each
//   chunk; at the chunk's end it is added to the fp32 total (the tensor
//   cores' round-toward-zero adds would bias a sum over all 9 C terms). The
//   two accumulators need 128 registers, so a consumer warpgroup owns one
//   64-pixel row of 128 channels (BN = 128) or two of 64 (BN = 64, F <= 64):
//   blocks of 2 x 64 px x 128 ch or 4 x 64 px x 64 ch.
// - Epilogue: bias in fp32, outputs stored as fp32.
// Bound on the H100: operations, three TF32 passes (3 * 278 GFLOP at 512 ->
// 512 and 184 x 320, 1.69 ms at 494.7 TF/s).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

// bf16 kernel
constexpr int kMW = 64;                      // output columns per block: one wgmma M tile
constexpr int kPW = kMW + 2;                 // haloed patch width (66)
constexpr int kKC = 64;                      // input channels per K chunk
constexpr int kStages = 4;                   // weight ring stages
constexpr int kConsumers = 2;                // consumer warpgroups
constexpr int kLoaders = 96;                 // producer warps 1-3 stage the input patch
constexpr int kBThreads = 128 * (kConsumers + 1);
constexpr int kStageLd = kMW + 8;            // bf16 per row of the epilogue's staging (conflict-free)

template <int BN, int R>
struct Plan {
  static constexpr int kRows = kConsumers * R;              // output rows per block
  static constexpr int kPix = (kRows + 2) * kPW;             // haloed patch pixels
  static constexpr int kGroup = kPix * 16;                   // bytes of one 8-channel group
  static constexpr int kPatch = 8 * kGroup;                  // bytes of one patch buffer
  static constexpr int kTile = BN * kKC * 2;                 // bytes of one (chunk, tap) weight tile
  static constexpr int kRing = (2 * kPatch + 1023) / 1024 * 1024;
  static constexpr int kBars = kRing + kStages * kTile;
  static constexpr int kSmem = kBars + 8 * (2 * kStages + 4) + 1024;   // + 1024-byte alignment slack
  static constexpr int kStaging = R * BN * kStageLd * 2;     // epilogue bytes per consumer warpgroup
  static_assert(kConsumers * kStaging <= 2 * kPatch, "the staging reuses the patch buffers");
  static_assert(kSmem <= 232448, "shared memory");
};

// fp32 kernel
constexpr int kKC32 = 16;                    // input channels per K chunk: 4 groups of 4
constexpr int kStages32 = 6;                 // weight ring stages
constexpr int kStageLd32 = kMW + 4;          // fp32 per row of the epilogue's staging (conflict-free)

template <int BN>
struct Plan32 {
  static constexpr int R = 128 / BN;                        // output rows per consumer warpgroup
  static constexpr int kN2 = BN / 2;                         // accumulator registers per row
  static constexpr int kRows = kConsumers * R;              // output rows per block
  static constexpr int kPix = (kRows + 2) * kPW;             // haloed patch pixels
  static constexpr int kGroup = kPix * 16;                   // bytes of one 4-channel group
  static constexpr int kImage = 4 * kGroup;                  // bytes of one chunk's hi or lo image
  static constexpr int kPatch = 2 * kImage;                  // bytes of one patch buffer (hi, lo)
  static constexpr int kTile = BN * kKC32 * 4;               // bytes of one (chunk, tap) hi or lo tile
  static constexpr int kRing = (2 * kPatch + 1023) / 1024 * 1024;
  static constexpr int kBars = kRing + kStages32 * 2 * kTile;
  static constexpr int kSmem = kBars + 8 * (2 * kStages32 + 4) + 1024;
  static constexpr int kStaging = R * BN * kStageLd32 * 4;   // epilogue bytes per consumer warpgroup
  static_assert(kConsumers * kStaging <= kBars, "the staging reuses the patch buffers and the ring");
  static_assert(kSmem <= 232448, "shared memory");
};

struct Geometry {
  int n_inner;                   // images = n_outer * n_inner (grid z)
  long long xso, xsi, xsc;       // input strides: outer batch, inner batch, channel
  long long oso, osi, osc;       // output strides
  int C, H, W, F, Cp, Fp;        // Cp, Fp: the packed weight's padded C and F
  int tiles_x;                   // column tiles per row of tiles
  int vec;                       // x, W and the input strides allow 16-byte loads
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// One 1-D bulk copy global -> shared, completing `bytes` on the mbarrier.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Shared-memory matrix descriptors (K-major). Plain: core matrices of 8 rows x
// 16 bytes, `lbo` bytes apart along K and `sbo` bytes apart along M/N.
// 128-byte swizzle: rows of 128 bytes (64 bf16 of K), 8-row groups 1024 apart.
__device__ __forceinline__ uint64_t desc_plain(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma's issue and wait.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ACC8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x N] += A[64 x 16] * B[16 x N], A and B bf16 in shared memory, d fp32.
// Thread t of the warpgroup holds rows 16 (t / 32) + (t % 32) / 4 + 8 i and
// columns 8 j + 2 (t % 4) + k in d[4 j + 2 i + k].
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56)
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "l"(da), "l"(db), "r"(1));
}

#undef ACC8

__device__ __forceinline__ uint32_t word(const uint4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Packs 8 channels of one patch pixel (2-byte loads, predicated) into its
// 16-byte slot.
template <class P>
__device__ __forceinline__ void load_pixel(unsigned char* dst, const unsigned short* xs, const Geometry& g,
                                           int grp, int py, int px, int c, int x0, int y0) {
  const int yy = y0 - 1 + py, xx = x0 - 1 + px, ch = c * kKC + grp * 8;
  const bool in = yy >= 0 && yy < g.H && xx >= 0 && xx < g.W;
  const unsigned short* src = xs + ch * g.xsc + (long long)yy * g.W + xx;
  unsigned short e[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) e[j] = (in && ch + j < g.C) ? __ldg(src + j * g.xsc) : 0;
  *reinterpret_cast<uint4*>(dst + grp * P::kGroup + (py * kPW + px) * 16) =
      make_uint4(e[0] | ((uint32_t)e[1] << 16), e[2] | ((uint32_t)e[3] << 16),
                 e[4] | ((uint32_t)e[5] << 16), e[6] | ((uint32_t)e[7] << 16));
}

// Chunk c's patch from 16-byte loads: item (group, row, v) is the 8 pixels
// x0 + 8v .. x0 + 8v + 7 of the group's 8 channels, one load per channel
// (8 consecutive items are 128 consecutive bytes of a channel row),
// transposed in registers into 8 pixel slots; the two halo columns come
// pixel by pixel. Needs W, the strides and x's address multiples of 8
// elements (then a vector is all inside or all outside the image).
template <class P>
__device__ __forceinline__ void load_patch_vec(unsigned char* dst, const unsigned short* xs, const Geometry& g,
                                               int c, int x0, int y0, int t) {
  constexpr int kPR = P::kRows + 2;          // patch rows
  constexpr int kItems = 8 * kPR * 8;
  const int v = t & 7;                       // every item of this thread has the same v
  const long long cs = g.xsc / 8;            // channel stride in 16-byte vectors
#pragma unroll 1
  for (int i0 = t; i0 < kItems; i0 += 2 * kLoaders) {
    uint4 in[2][8];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int item = i0 + u * kLoaders, py = (item >> 3) % kPR, grp = (item >> 3) / kPR;
      const int yy = y0 - 1 + py, xx = x0 + 8 * v, ch = c * kKC + grp * 8;
      const bool ok = item < kItems && yy >= 0 && yy < g.H && xx < g.W;
      const uint4* src = reinterpret_cast<const uint4*>(xs + ch * g.xsc + (long long)yy * g.W + xx);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        in[u][j] = (ok && ch + j < g.C) ? __ldg(src + j * cs) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int item = i0 + u * kLoaders, py = (item >> 3) % kPR, grp = (item >> 3) / kPR;
      if (item >= kItems) break;
      // Word k of channel j holds pixels 2k (low half) and 2k + 1 (high half).
      uint4 o[8];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        uint32_t lo[4], hi[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          lo[m] = __byte_perm(word(in[u][2 * m], k), word(in[u][2 * m + 1], k), 0x5410);
          hi[m] = __byte_perm(word(in[u][2 * m], k), word(in[u][2 * m + 1], k), 0x7632);
        }
        o[2 * k] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
        o[2 * k + 1] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      }
      // Store pixel i ^ v at step i: the 8 lanes of a quarter-warp (v = 0..7)
      // then write 8 distinct 16-byte bank groups.
#pragma unroll
      for (int bit = 1; bit < 8; bit <<= 1) {
        const bool sw = v & bit;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (i & bit) continue;
          const uint4 a = o[i], b = o[i | bit];
          o[i] = sw ? b : a;
          o[i | bit] = sw ? a : b;
        }
      }
      unsigned char* row = dst + grp * P::kGroup + (py * kPW + 1 + 8 * v) * 16;
#pragma unroll
      for (int i = 0; i < 8; ++i) *reinterpret_cast<uint4*>(row + (i ^ v) * 16) = o[i];
    }
  }
  for (int item = t; item < 8 * kPR * 2; item += kLoaders) {
    const int rest = item >> 1;
    load_pixel<P>(dst, xs, g, rest / kPR, rest % kPR, (item & 1) ? kPW - 1 : 0, c, x0, y0);
  }
}

// Chunk c's patch pixel by pixel (any alignment): item (group, pixel),
// pixel fastest, so a warp's loads of one channel are consecutive x.
template <class P>
__device__ __forceinline__ void load_patch_px(unsigned char* dst, const unsigned short* xs, const Geometry& g,
                                              int c, int x0, int y0, int t) {
#pragma unroll 2
  for (int item = t; item < 8 * P::kPix; item += kLoaders) {
    const int grp = item / P::kPix, pix = item - grp * P::kPix;
    load_pixel<P>(dst, xs, g, grp, pix / kPW, pix % kPW, c, x0, y0);
  }
}

template <int BN, int R>
__global__ void __launch_bounds__(kBThreads, 1)
conv3x3_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wp,
                    const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, Geometry g) {
  using P = Plan<BN, R>;
  extern __shared__ unsigned char smem_raw[];
  // [patch 0][patch 1][weight ring][mbarriers], from a 1024-byte boundary
  // (the swizzled weight tiles need it).
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bars = base + P::kBars;
  // full/empty mbarriers: weight stage s at bars + 8 s / + 8 (kStages + s),
  // patch buffer b at bars + 8 (2 kStages + b) / + 8 (2 kStages + 2 + b).
  const uint32_t wfull = bars, wempty = bars + 8 * kStages;
  const uint32_t pfull = bars + 16 * kStages, pempty = pfull + 16;

  const int img = blockIdx.z;
  const int n0 = blockIdx.x * BN;
  const int x0 = (blockIdx.y % g.tiles_x) * kMW, y0 = (blockIdx.y / g.tiles_x) * P::kRows;
  const int nchunks = g.Cp / kKC;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(wfull + 8 * s, 1);
      mbar_init(wempty + 8 * s, 4 * kConsumers);       // one arrival per consumer warp
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(pfull + 8 * b, kLoaders);
      mbar_init(pempty + 8 * b, 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer warpgroup ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 104;\n" ::: "memory");
    const int warp = (threadIdx.x >> 5) & 3;
    if (warp == 0) {
      // The weights: tile (N block, chunk, tap) at step chunk * 9 + tap.
      if ((threadIdx.x & 31) == 0) {
        const long long tile = (long long)BN * kKC;
        const __nv_bfloat16* src = wp + (long long)blockIdx.x * nchunks * 9 * tile;
        for (int step = 0; step < nchunks * 9; ++step) {
          const int s = step % kStages;
          if (step >= kStages) mbar_wait(wempty + 8 * s, (step / kStages - 1) & 1);
          mbar_expect_tx(wfull + 8 * s, P::kTile);
          bulk_load(base + P::kRing + s * P::kTile, src + step * tile, P::kTile, wfull + 8 * s);
        }
      }
    } else {
      // The input patch, by warps 1-3.
      const int t = threadIdx.x - (128 * kConsumers + 32);
      const unsigned short* xs = reinterpret_cast<const unsigned short*>(x) +
                                 (img / g.n_inner) * g.xso + (img % g.n_inner) * g.xsi;
      for (int c = 0; c < nchunks; ++c) {
        const int b = c & 1;
        if (c >= 2) mbar_wait(pempty + 8 * b, ((c >> 1) - 1) & 1);
        unsigned char* dst = smem + b * P::kPatch;
        if (g.vec)
          load_patch_vec<P>(dst, xs, g, c, x0, y0, t);
        else
          load_patch_px<P>(dst, xs, g, c, x0, y0, t);
        // Make the generic-proxy stores visible to wgmma (async proxy).
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(pfull + 8 * b);
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 200;\n" ::: "memory");
  const int lane = threadIdx.x & 31, w4 = (threadIdx.x >> 5) & 3;
  float acc[R][BN / 2];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[r][i] = 0.f;
    fence_acc(acc[r]);
  }

  int step = 0;
  for (int c = 0; c < nchunks; ++c) {
    const int b = c & 1;
    mbar_wait(pfull + 8 * b, (c >> 1) & 1);
    // The warpgroup's first output row, tap (0, 0), channels 0-15 of the chunk.
    const uint32_t pa = base + b * P::kPatch + wg * R * kPW * 16;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap, ++step) {
      const int s = step % kStages;
      mbar_wait(wfull + 8 * s, (step / kStages) & 1);
      const uint32_t a0 = pa + ((tap / 3) * kPW + tap % 3) * 16;
      const uint32_t b0 = base + P::kRing + s * P::kTile;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKC / 16; ++kk) {
        const uint64_t db = desc_sw128(b0 + kk * 32);
#pragma unroll
        for (int r = 0; r < R; ++r)
          wgmma(acc[r], desc_plain(a0 + r * kPW * 16 + 2 * kk * P::kGroup, P::kGroup, 128), db);
      }
      wgmma_commit();
      wgmma_wait<1>();          // the previous step's wgmmas are done: release its buffers
      if (step > 0 && lane == 0) {
        mbar_arrive(wempty + 8 * ((step - 1) % kStages));
        if (tap == 0) mbar_arrive(pempty + 8 * (b ^ 1));   // the last tap of chunk c - 1
      }
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int r = 0; r < R; ++r) fence_acc(acc[r]);

  // Epilogue. Both consumer warpgroups are past their last wgmma and every
  // copy has landed, so the patch buffers hold the staging: fp32 bias, one
  // rounding, [row][channel][64 pixels] per warpgroup.
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kConsumers) : "memory");
  __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(smem + wg * P::kStaging);
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int fl = nt * 8 + 2 * (lane & 3) + j;
      const float bf = (bias != nullptr && n0 + fl < g.F) ? bias[n0 + fl] : 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
          st[(r * BN + fl) * kStageLd + w4 * 16 + (lane >> 2) + 8 * i] =
              __float2bfloat16_rn(acc[r][nt * 4 + 2 * i + j] + bf);
      }
    }
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
  // Each warp stores whole 64-pixel rows of one channel: 32 x 2 pixels where
  // W and the strides keep pairs 4-byte aligned, else 2 x 32 single pixels.
  __nv_bfloat16* ob = out + (img / g.n_inner) * g.oso + (img % g.n_inner) * g.osi;
  const bool pairs = ((g.W | g.osc) & 1) == 0 && (reinterpret_cast<uintptr_t>(ob) & 3) == 0;
  for (int row = w4; row < R * BN; row += 4) {
    const int r = row / BN, f = n0 + row % BN, y = y0 + wg * R + r;
    if (f >= g.F || y >= g.H) continue;
    __nv_bfloat16* orow = ob + f * g.osc + (long long)y * g.W + x0;
    const __nv_bfloat16* srow = st + row * kStageLd;
    if (pairs) {
      if (x0 + 2 * lane < g.W)
        *reinterpret_cast<uint32_t*>(orow + 2 * lane) = *reinterpret_cast<const uint32_t*>(srow + 2 * lane);
    } else {
      if (x0 + lane < g.W) orow[lane] = srow[lane];
      if (x0 + 32 + lane < g.W) orow[32 + lane] = srow[32 + lane];
    }
  }
}

// Packs 4 channels of one patch pixel (4-byte loads, predicated), split into
// tf32 hi and lo, into its 16-byte slots of the hi and lo images.
template <class P>
__device__ __forceinline__ void load_pixel32(unsigned char* dst, const float* xs, const Geometry& g, int grp,
                                             int py, int px, int c, int x0, int y0) {
  const int yy = y0 - 1 + py, xx = x0 - 1 + px, ch = c * kKC32 + grp * 4;
  const bool in = yy >= 0 && yy < g.H && xx >= 0 && xx < g.W;
  const float* src = xs + ch * g.xsc + (long long)yy * g.W + xx;
  uint32_t hi[4], lo[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) tf32x3::split((in && ch + j < g.C) ? __ldg(src + j * g.xsc) : 0.f, hi[j], lo[j]);
  unsigned char* slot = dst + grp * P::kGroup + (py * kPW + px) * 16;
  *reinterpret_cast<uint4*>(slot) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  *reinterpret_cast<uint4*>(slot + P::kImage) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
}

// Chunk c's patch from 16-byte loads: item (group, row, v) is the 4 pixels
// x0 + 4v .. x0 + 4v + 3 of the group's 4 channels, one load per channel,
// transposed in registers into 4 pixel slots of each image; the two halo
// columns come pixel by pixel. Needs W, the strides and x's address
// multiples of 4 elements (then a vector is all inside or all outside the
// image).
template <class P>
__device__ __forceinline__ void load_patch32_vec(unsigned char* dst, const float* xs, const Geometry& g, int c,
                                                 int x0, int y0, int t) {
  constexpr int kPR = P::kRows + 2;          // patch rows
  constexpr int kItems = 4 * kPR * 16;
  const int v = t & 15;                      // every item of this thread has the same v
  const int rot = (v >> 1) & 3;              // slot rotation: a quarter-warp's stores hit 8 bank groups
  const long long cs = g.xsc / 4;            // channel stride in 16-byte vectors
#pragma unroll 1
  for (int i0 = t; i0 < kItems; i0 += 2 * kLoaders) {
    float4 in[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int item = i0 + u * kLoaders, py = (item >> 4) % kPR, grp = (item >> 4) / kPR;
      const int yy = y0 - 1 + py, xx = x0 + 4 * v, ch = c * kKC32 + grp * 4;
      const bool ok = item < kItems && yy >= 0 && yy < g.H && xx < g.W;
      const float4* src = reinterpret_cast<const float4*>(xs + ch * g.xsc + (long long)yy * g.W + xx);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        in[u][j] = (ok && ch + j < g.C) ? __ldg(src + j * cs) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int item = i0 + u * kLoaders, py = (item >> 4) % kPR, grp = (item >> 4) / kPR;
      if (item >= kItems) break;
      // Pixel i of the vector: (channel 0..3) = (in[0].i, .., in[3].i).
      uint4 h[4], l[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4* q = in[u];
        h[i] = tf32x3::split4(i == 0   ? make_float4(q[0].x, q[1].x, q[2].x, q[3].x)
                              : i == 1 ? make_float4(q[0].y, q[1].y, q[2].y, q[3].y)
                              : i == 2 ? make_float4(q[0].z, q[1].z, q[2].z, q[3].z)
                                       : make_float4(q[0].w, q[1].w, q[2].w, q[3].w),
                              l[i]);
      }
      tf32x3::rotate4(h, rot);
      tf32x3::rotate4(l, rot);
      unsigned char* row = dst + grp * P::kGroup + (py * kPW + 1 + 4 * v) * 16;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        unsigned char* slot = row + ((i + rot) & 3) * 16;
        *reinterpret_cast<uint4*>(slot) = h[i];
        *reinterpret_cast<uint4*>(slot + P::kImage) = l[i];
      }
    }
  }
  for (int item = t; item < 4 * kPR * 2; item += kLoaders) {
    const int rest = item >> 1;
    load_pixel32<P>(dst, xs, g, rest / kPR, rest % kPR, (item & 1) ? kPW - 1 : 0, c, x0, y0);
  }
}

// Chunk c's patch pixel by pixel (any alignment): item (group, pixel),
// pixel fastest, so a warp's loads of one channel are consecutive x.
template <class P>
__device__ __forceinline__ void load_patch32_px(unsigned char* dst, const float* xs, const Geometry& g, int c,
                                                int x0, int y0, int t) {
#pragma unroll 2
  for (int item = t; item < 4 * P::kPix; item += kLoaders) {
    const int grp = item / P::kPix, pix = item - grp * P::kPix;
    load_pixel32<P>(dst, xs, g, grp, pix / kPW, pix % kPW, c, x0, y0);
  }
}

// One tap of a chunk: wait for its weight stage, then per 8-channel K step
// three wgmma (small terms first: lo * hi, hi * lo, then hi * hi) per
// output row into the partial accumulators, fresh at the chunk's first tap;
// one commit.
template <class P>
__device__ __forceinline__ void issue_tap32(float (&part)[P::R][P::kN2], uint32_t pa, uint32_t base, int step,
                                            int tap, uint32_t wfull) {
  constexpr int BN = 2 * P::kN2;
  const int s = step % kStages32;
  mbar_wait(wfull + 8 * s, (step / kStages32) & 1);
  const uint32_t a0 = pa + ((tap / 3) * kPW + tap % 3) * 16;
  const uint32_t b0 = base + P::kRing + s * 2 * P::kTile;
  wgmma_fence();
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
    const uint32_t ap = a0 + (pass == 0 ? P::kImage : 0), bp = b0 + (pass == 1 ? P::kTile : 0);
#pragma unroll
    for (int kk = 0; kk < kKC32 / 8; ++kk) {
      const uint64_t db = tf32x3::desc(bp + kk * 2 * BN * 16, BN * 16, 128);
#pragma unroll
      for (int r = 0; r < P::R; ++r)
        tf32x3::mma(part[r], tf32x3::desc(ap + r * kPW * 16 + kk * 2 * P::kGroup, P::kGroup, 128), db,
                    tap > 0 || pass > 0 || kk > 0);
    }
  }
  wgmma_commit();
}

template <int BN>
__global__ void __launch_bounds__(kBThreads, 1)
conv3x3_fp32_kernel(const float* __restrict__ x, const float* __restrict__ wp, const float* __restrict__ bias,
                    float* __restrict__ out, Geometry g) {
  using P = Plan32<BN>;
  constexpr int R = P::R;
  extern __shared__ unsigned char smem_raw[];
  // [patch 0 hi, lo][patch 1 hi, lo][weight ring, each stage hi then lo][mbarriers]
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bars = base + P::kBars;
  const uint32_t wfull = bars, wempty = bars + 8 * kStages32;
  const uint32_t pfull = bars + 16 * kStages32, pempty = pfull + 16;

  const int img = blockIdx.z;
  const int n0 = blockIdx.x * BN;
  const int x0 = (blockIdx.y % g.tiles_x) * kMW, y0 = (blockIdx.y / g.tiles_x) * P::kRows;
  const int nchunks = g.Cp / kKC32;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages32; ++s) {
      mbar_init(wfull + 8 * s, 1);
      mbar_init(wempty + 8 * s, 4 * kConsumers);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(pfull + 8 * b, kLoaders);
      mbar_init(pempty + 8 * b, 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer warpgroup ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 104;\n" ::: "memory");
    const int warp = (threadIdx.x >> 5) & 3;
    if (warp == 0) {
      // The weights: tile (N block, chunk, tap), hi then lo, at step chunk * 9 + tap.
      if ((threadIdx.x & 31) == 0) {
        const long long tile = 2LL * BN * kKC32;
        const float* src = wp + (long long)blockIdx.x * nchunks * 9 * tile;
        for (int step = 0; step < nchunks * 9; ++step) {
          const int s = step % kStages32;
          if (step >= kStages32) mbar_wait(wempty + 8 * s, (step / kStages32 - 1) & 1);
          mbar_expect_tx(wfull + 8 * s, 2 * P::kTile);
          bulk_load(base + P::kRing + s * 2 * P::kTile, src + step * tile, 2 * P::kTile, wfull + 8 * s);
        }
      }
    } else {
      // The input patch, split into hi and lo, by warps 1-3.
      const int t = threadIdx.x - (128 * kConsumers + 32);
      const float* xs = x + (img / g.n_inner) * g.xso + (img % g.n_inner) * g.xsi;
      for (int c = 0; c < nchunks; ++c) {
        const int b = c & 1;
        if (c >= 2) mbar_wait(pempty + 8 * b, ((c >> 1) - 1) & 1);
        unsigned char* dst = smem + b * P::kPatch;
        if (g.vec)
          load_patch32_vec<P>(dst, xs, g, c, x0, y0, t);
        else
          load_patch32_px<P>(dst, xs, g, c, x0, y0, t);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(pfull + 8 * b);
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 200;\n" ::: "memory");
  const int lane = threadIdx.x & 31, w4 = (threadIdx.x >> 5) & 3;
  float acc[R][P::kN2], part[R][P::kN2];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int i = 0; i < P::kN2; ++i) acc[r][i] = part[r][i] = 0.f;
    fence_acc(part[r]);
  }

  int step = 0;
  for (int c = 0; c < nchunks; ++c) {
    const int b = c & 1;
    mbar_wait(pfull + 8 * b, (c >> 1) & 1);
    // The warpgroup's first output row, tap (0, 0), channels 0-3 of the chunk, hi image.
    const uint32_t pa = base + b * P::kPatch + wg * R * kPW * 16;
#pragma unroll 1
    for (int tap = 0; tap < 8; ++tap, ++step) {
      issue_tap32<P>(part, pa, base, step, tap, wfull);
      wgmma_wait<1>();          // the previous tap's wgmmas are done: release its stage
      if (tap > 0 && lane == 0) mbar_arrive(wempty + 8 * ((step - 1) % kStages32));
    }
    issue_tap32<P>(part, pa, base, step, 8, wfull);
    wgmma_wait<0>();            // the chunk is done: release its stages and patch, add it up
    if (lane == 0) {
      mbar_arrive(wempty + 8 * ((step - 1) % kStages32));
      mbar_arrive(wempty + 8 * (step % kStages32));
      mbar_arrive(pempty + 8 * b);
    }
    ++step;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      fence_acc(part[r]);
#pragma unroll
      for (int i = 0; i < P::kN2; ++i) acc[r][i] += part[r][i];
    }
  }

  // Epilogue: fp32 bias, staged [row][channel][64 pixels] per warpgroup in
  // the patch buffers and the ring (every copy has landed and been read).
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kConsumers) : "memory");
  float* st = reinterpret_cast<float*>(smem + wg * P::kStaging);
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int fl = nt * 8 + 2 * (lane & 3) + j;
      const float bf = (bias != nullptr && n0 + fl < g.F) ? bias[n0 + fl] : 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
          st[(r * BN + fl) * kStageLd32 + w4 * 16 + (lane >> 2) + 8 * i] = acc[r][nt * 4 + 2 * i + j] + bf;
      }
    }
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
  // Each warp stores whole 64-pixel rows of one channel: 32 x 2 pixels where
  // W and the strides keep pairs 8-byte aligned, else 2 x 32 single pixels.
  float* ob = out + (img / g.n_inner) * g.oso + (img % g.n_inner) * g.osi;
  const bool pairs = ((g.W | g.osc) & 1) == 0 && (reinterpret_cast<uintptr_t>(ob) & 7) == 0;
  for (int row = w4; row < R * BN; row += 4) {
    const int r = row / BN, f = n0 + row % BN, y = y0 + wg * R + r;
    if (f >= g.F || y >= g.H) continue;
    float* orow = ob + f * g.osc + (long long)y * g.W + x0;
    const float* srow = st + row * kStageLd32;
    if (pairs) {
      if (x0 + 2 * lane < g.W)
        *reinterpret_cast<float2*>(orow + 2 * lane) = *reinterpret_cast<const float2*>(srow + 2 * lane);
    } else {
      if (x0 + lane < g.W) orow[lane] = srow[lane];
      if (x0 + 32 + lane < g.W) orow[32 + lane] = srow[32 + lane];
    }
  }
}

// launched[0..5] = the grid (x, y, z) and a block's tile (output rows,
// columns, channels) of the launch being made.
void report(int* launched, dim3 grid, int rows, int cols, int channels) {
  const int v[6] = {(int)grid.x, (int)grid.y, (int)grid.z, rows, cols, channels};
  for (int i = 0; i < 6; ++i) launched[i] = v[i];
}

template <int BN, int R>
cudaError_t launch_bf16(const void* x, const void* wp, const void* bias, void* out, Geometry g,
                        int images, int* launched, cudaStream_t s) {
  using P = Plan<BN, R>;
  // The attribute is per device: set it at every launch (the launch may be
  // the first on this device).
  const cudaError_t attr = cudaFuncSetAttribute(
      conv3x3_bf16_kernel<BN, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (attr != cudaSuccess) return attr;
  g.tiles_x = (g.W + kMW - 1) / kMW;
  const long long tiles = (long long)g.tiles_x * ((g.H + P::kRows - 1) / P::kRows);
  if (tiles > 65535) return cudaErrorInvalidValue;
  dim3 grid(g.Fp / BN, (unsigned)tiles, images);
  report(launched, grid, P::kRows, kMW, BN);
  conv3x3_bf16_kernel<BN, R><<<grid, kBThreads, P::kSmem, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wp),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), g);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_fp32(const void* x, const void* wp, const void* bias, void* out, Geometry g,
                        int images, int* launched, cudaStream_t s) {
  using P = Plan32<BN>;
  const cudaError_t attr = cudaFuncSetAttribute(
      conv3x3_fp32_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (attr != cudaSuccess) return attr;
  g.tiles_x = (g.W + kMW - 1) / kMW;
  const long long tiles = (long long)g.tiles_x * ((g.H + P::kRows - 1) / P::kRows);
  if (tiles > 65535) return cudaErrorInvalidValue;
  dim3 grid(g.Fp / BN, (unsigned)tiles, images);
  report(launched, grid, P::kRows, kMW, BN);
  conv3x3_fp32_kernel<BN><<<grid, kBThreads, P::kSmem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(wp), static_cast<const float*>(bias),
      static_cast<float*>(out), g);
  return cudaGetLastError();
}

}  // namespace

// x, out: the input and output with the strides above (elements); wp: the
// weight packed by pack_conv3x3_weight in x's type -- bf16: (Fp / pack_n,
// Cp / 64, 9, pack_n, 64) swizzled tiles, Cp a multiple of 64; fp32:
// (Fp / pack_n, Cp / 16, 9, 2, 4, pack_n, 4) hi and lo tiles, Cp a multiple
// of 16 -- pack_n 64 or 128, zero-padded; bias: fp32 (F,) or null. A block is
// pack_n output channels by 2 * rows output rows by 64 columns: bf16 rows 1
// or 2, fp32 rows = 128 / pack_n. launched: 6 ints, set to the grid and
// block tile of the launch (see report). Returns the launch's CUDA error.
extern "C" int fs_conv3x3(const void* x, const void* wp, const void* bias, void* out,
                          int n_outer, int n_inner, long long xso, long long xsi, long long xsc,
                          long long oso, long long osi, long long osc, int C, int H, int W, int F,
                          int Cp, int Fp, int pack_n, int rows, int is_bf16, int* launched,
                          void* stream) {
  const int images = n_outer * n_inner;
  if (images <= 0 || images > 65535 || H <= 0 || W <= 0 || F > Fp || C > Cp)
    return (int)cudaErrorInvalidValue;
  const int vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0 && ((W | xsc | xso | xsi) & 7) == 0;
  Geometry g{n_inner, xso, xsi, xsc, oso, osi, osc, C, H, W, F, Cp, Fp, 0, vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    if (Cp % kKC32 || (pack_n != 64 && pack_n != 128) || Fp % pack_n || rows != 128 / pack_n)
      return (int)cudaErrorInvalidValue;
    g.vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0 && ((W | xsc | xso | xsi) & 3) == 0;
    return (int)(pack_n == 128 ? launch_fp32<128>(x, wp, bias, out, g, images, launched, s)
                               : launch_fp32<64>(x, wp, bias, out, g, images, launched, s));
  }
  if (Cp % kKC || (pack_n != 64 && pack_n != 128) || Fp % pack_n || (rows != 1 && rows != 2))
    return (int)cudaErrorInvalidValue;
  if (pack_n == 128)
    return (int)(rows == 2 ? launch_bf16<128, 2>(x, wp, bias, out, g, images, launched, s)
                           : launch_bf16<128, 1>(x, wp, bias, out, g, images, launched, s));
  return (int)(rows == 2 ? launch_bf16<64, 2>(x, wp, bias, out, g, images, launched, s)
                         : launch_bf16<64, 1>(x, wp, bias, out, g, images, launched, s));
}
