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
// fp32 (the model without mixed precision): the same tiling on the fp32 FMA
// units (no TF32), 64 output channels per block, each thread one column of
// 4 output rows x 8 channels, weights read as warp-wide broadcasts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTH = 4;                       // output rows per block
constexpr int kTW = 32;                      // output columns per block
constexpr int kHW = kTW + 2;                 // haloed patch width
constexpr int kHaloPix = (kTH + 2) * kHW;    // haloed patch pixels (204)
constexpr int kThreads = 256;

// fp32 kernel
constexpr int kFBN = 64;
constexpr int kFKC = 8;

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

struct Geometry {
  int n_inner;                   // images = n_outer * n_inner (grid z)
  long long xso, xsi, xsc;       // input strides: outer batch, inner batch, channel
  long long oso, osi, osc;       // output strides
  int C, H, W, F, Cp, Fp;        // Cp, Fp: the packed weight's padded C and F
  int tiles_x;                   // column tiles per row of tiles
  int vec;                       // bf16: x, W and the input strides allow 16-byte loads
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

__global__ void __launch_bounds__(kThreads)
conv3x3_fp32_kernel(const float* __restrict__ x, const float* __restrict__ wp,
                    const float* __restrict__ bias, float* __restrict__ out, Geometry g) {
  __shared__ float s_in[kFKC][kTH + 2][kHW];
  __shared__ __align__(16) float s_w[kFKC][9][kFBN];

  const int img = blockIdx.z;
  const float* xb = x + (img / g.n_inner) * g.xso + (img % g.n_inner) * g.xsi;
  float* ob = out + (img / g.n_inner) * g.oso + (img % g.n_inner) * g.osi;
  const int x0 = (blockIdx.x % g.tiles_x) * kTW, y0 = (blockIdx.x / g.tiles_x) * kTH;
  const int n0 = blockIdx.y * kFBN;
  const int tx = threadIdx.x & 31;            // output column in the tile
  const int fw = (threadIdx.x >> 5) * 8;      // the warp's 8 channels

  float acc[kTH][8];
#pragma unroll
  for (int r = 0; r < kTH; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;

  for (int c0 = 0; c0 < g.Cp; c0 += kFKC) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kFKC * kHaloPix; idx += kThreads) {
      const int c = idx / kHaloPix, pix = idx % kHaloPix;
      const int yy = y0 - 1 + pix / kHW, xx = x0 - 1 + pix % kHW;
      float v = 0.f;
      if (c0 + c < g.C && yy >= 0 && yy < g.H && xx >= 0 && xx < g.W)
        v = xb[(c0 + c) * g.xsc + (long long)yy * g.W + xx];
      s_in[c][pix / kHW][pix % kHW] = v;
    }
    for (int idx = threadIdx.x; idx < kFKC * 9 * kFBN; idx += kThreads) {
      const int c = idx % kFKC, row = idx / kFKC;   // row = tap * kFBN + n
      const int tap = row / kFBN, n = row % kFBN;
      s_w[c][tap][n] = wp[((long long)tap * g.Fp + n0 + n) * g.Cp + c0 + c];
    }
    __syncthreads();

#pragma unroll 1
    for (int c = 0; c < kFKC; ++c) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        const float4 w0 = *reinterpret_cast<const float4*>(&s_w[c][tap][fw]);
        const float4 w1 = *reinterpret_cast<const float4*>(&s_w[c][tap][fw + 4]);
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int r = 0; r < kTH; ++r) {
          const float a = s_in[c][r + dy][tx + dx];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(a, wv[j], acc[r][j]);
        }
      }
    }
  }

  const int xx = x0 + tx;
  if (xx >= g.W) return;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int f = n0 + fw + j;
    if (f >= g.F) continue;
    const float bf = bias ? bias[f] : 0.f;
#pragma unroll
    for (int r = 0; r < kTH; ++r) {
      const int y = y0 + r;
      if (y < g.H) ob[f * g.osc + (long long)y * g.W + xx] = acc[r][j] + bf;
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

}  // namespace

// x, out: the input and output with the strides above (elements); wp: the
// weight packed by pack_conv3x3_weight in x's type -- bf16: (Fp / pack_n,
// Cp / 64, 9, pack_n, 64) swizzled tiles, Cp a multiple of 64, pack_n 64 or
// 128; fp32: (9, Fp, Cp), Fp a multiple of 128, Cp of 16 -- zero-padded;
// bias: fp32 (F,) or null. bf16 only: a block is pack_n output channels by
// 2 * rows output rows (rows 1 or 2) by 64 columns. launched: 6 ints, set
// to the grid and block tile of the launch (see report). Returns the
// launch's CUDA error.
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
    if (Fp % 128 || Cp % 16) return (int)cudaErrorInvalidValue;
    g.tiles_x = (W + kTW - 1) / kTW;
    dim3 grid((unsigned)(g.tiles_x * ((H + kTH - 1) / kTH)), Fp / kFBN, images);
    report(launched, grid, kTH, kTW, kFBN);
    conv3x3_fp32_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(wp),
        static_cast<const float*>(bias), static_cast<float*>(out), g);
    return (int)cudaGetLastError();
  }
  if (Cp % kKC || (pack_n != 64 && pack_n != 128) || Fp % pack_n || (rows != 1 && rows != 2))
    return (int)cudaErrorInvalidValue;
  if (pack_n == 128)
    return (int)(rows == 2 ? launch_bf16<128, 2>(x, wp, bias, out, g, images, launched, s)
                           : launch_bf16<128, 1>(x, wp, bias, out, g, images, launched, s));
  return (int)(rows == 2 ? launch_bf16<64, 2>(x, wp, bias, out, g, images, launched, s)
                         : launch_bf16<64, 1>(x, wp, bias, out, g, images, launched, s));
}
