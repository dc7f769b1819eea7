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
// bf16 (the main path): a block owns a tile of 4 rows x 32 columns of output
// pixels and 128 output channels, with 8 warps of 32 pixels x 64 channels
// each (mma.sync m16n8k16, fp32 accumulators). The K loop walks C in chunks
// of 16 channels: each chunk stages the haloed 6 x 34 input patch (read
// straight from NCHW, consecutive x contiguous, padding ring and ragged C by
// predicated loads, no padded copy) pixel-major in shared memory, and the
// chunk's 9 x 128 x 16 weights from the repacked (9, Fp, Cp) bf16 layout
// (zero-padded, so F and C need no predicate there); then all 9 taps are 9
// shifted reads of the same patch, so the input is read from device memory
// once per (chunk, F block) and not 9 times. Bias is added in the fp32
// epilogue, before the one rounding to bf16. This first version has no
// cp.async/TMA pipeline and no wgmma; those come later.
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

// bf16 kernel
constexpr int kBN = 128;                     // output channels per block
constexpr int kKC = 16;                      // input channels per chunk
constexpr int kLds = kKC + 8;                // bf16 per shared row: 12 words, conflict-free fragments
constexpr int kSmemIn = kHaloPix * kLds;     // bf16 elements
constexpr int kSmemW = 9 * kBN * kLds;
constexpr int kSmemBytes = (kSmemIn + kSmemW) * 2;

// fp32 kernel
constexpr int kFBN = 64;
constexpr int kFKC = 8;

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

struct Geometry {
  int n_inner;                   // images = n_outer * n_inner (grid z)
  long long xso, xsi, xsc;       // input strides: outer batch, inner batch, channel
  long long oso, osi, osc;       // output strides
  int C, H, W, F, Cp, Fp;        // Cp, Fp: the packed weight's padded C and F
  int tiles_x;                   // column tiles per row of tiles
};

__global__ void __launch_bounds__(kThreads)
conv3x3_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wp,
                    const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, Geometry g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* s_in = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [pixel][kLds]
  __nv_bfloat16* s_w = s_in + kSmemIn;                                 // [tap][n][kLds]
  const uint32_t* s_in32 = reinterpret_cast<const uint32_t*>(s_in);
  const uint32_t* s_w32 = reinterpret_cast<const uint32_t*>(s_w);

  const int img = blockIdx.z;
  const __nv_bfloat16* xb = x + (img / g.n_inner) * g.xso + (img % g.n_inner) * g.xsi;
  __nv_bfloat16* ob = out + (img / g.n_inner) * g.oso + (img % g.n_inner) * g.osi;
  const int x0 = (blockIdx.x % g.tiles_x) * kTW, y0 = (blockIdx.x / g.tiles_x) * kTH;
  const int n0 = blockIdx.y * kBN;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t = lane & 3;     // fragment row group, thread in group
  const int wy = warp & 3;                    // the warp's output row in the tile
  const int wn = (warp >> 2) * 64;            // the warp's first channel in the block

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  const unsigned short* xs = reinterpret_cast<const unsigned short*>(xb);
  for (int c0 = 0; c0 < g.Cp; c0 += kKC) {
    __syncthreads();  // the previous chunk is consumed
    // Haloed input patch, two channels per 32-bit word, pixel-major.
    for (int idx = threadIdx.x; idx < (kKC / 2) * kHaloPix; idx += kThreads) {
      const int pair = idx / kHaloPix, pix = idx % kHaloPix;
      const int yy = y0 - 1 + pix / kHW, xx = x0 - 1 + pix % kHW;
      const int c = c0 + 2 * pair;
      uint32_t v = 0u;
      if (yy >= 0 && yy < g.H && xx >= 0 && xx < g.W) {
        const long long off = (long long)yy * g.W + xx;
        if (c < g.C) v = xs[c * g.xsc + off];
        if (c + 1 < g.C) v |= (uint32_t)xs[(c + 1) * g.xsc + off] << 16;
      }
      reinterpret_cast<uint32_t*>(s_in)[pix * (kLds / 2) + pair] = v;
    }
    // The chunk's weights: 9 taps x 128 channels x 16 input channels, 2 x 16 bytes per row.
    for (int idx = threadIdx.x; idx < 9 * kBN * 2; idx += kThreads) {
      const int half = idx & 1, row = idx >> 1;
      const int tap = row / kBN, n = row % kBN;
      const uint4 v = *reinterpret_cast<const uint4*>(
          wp + ((long long)tap * g.Fp + n0 + n) * g.Cp + c0 + half * 8);
      *reinterpret_cast<uint4*>(&s_w[row * kLds + half * 8]) = v;
    }
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int p = (wy + dy) * kHW + mt * 16 + dx + gr;   // patch pixel of fragment row gr
        a[mt][0] = s_in32[p * (kLds / 2) + t];
        a[mt][1] = s_in32[(p + 8) * (kLds / 2) + t];
        a[mt][2] = s_in32[p * (kLds / 2) + 4 + t];
        a[mt][3] = s_in32[(p + 8) * (kLds / 2) + 4 + t];
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int r = tap * kBN + wn + nt * 8 + gr;
        const uint32_t b0 = s_w32[r * (kLds / 2) + t];
        const uint32_t b1 = s_w32[r * (kLds / 2) + 4 + t];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          mma_bf16(acc[mt][nt], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b0, b1);
      }
    }
  }

  // Epilogue: fp32 bias, one rounding, predicated NCHW stores.
  const int y = y0 + wy;
  if (y >= g.H) return;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int f = n0 + wn + nt * 8 + 2 * t + j;
      if (f >= g.F) continue;
      const float bf = bias ? bias[f] : 0.f;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int xx = x0 + mt * 16 + gr + 8 * h;
          if (xx < g.W)
            ob[f * g.osc + (long long)y * g.W + xx] = __float2bfloat16_rn(acc[mt][nt][2 * h + j] + bf);
        }
      }
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

}  // namespace

// x, out: the input and output with the strides above (elements); wp: the
// weight repacked to (9, Fp, Cp) in x's type, zero-padded (Fp a multiple of
// 128, Cp of 16); bias: fp32 (F,) or null. Returns the launch's CUDA error.
extern "C" int fs_conv3x3(const void* x, const void* wp, const void* bias, void* out,
                          int n_outer, int n_inner, long long xso, long long xsi, long long xsc,
                          long long oso, long long osi, long long osc, int C, int H, int W, int F,
                          int Cp, int Fp, int is_bf16, void* stream) {
  if (n_outer * n_inner <= 0 || n_outer * n_inner > 65535 || Fp % kBN || Cp % kKC || F > Fp ||
      C > Cp)
    return (int)cudaErrorInvalidValue;
  Geometry g{n_inner, xso, xsi, xsc, oso, osi, osc, C, H, W, F, Cp, Fp, (W + kTW - 1) / kTW};
  const unsigned tiles = (unsigned)(g.tiles_x * ((H + kTH - 1) / kTH));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    // The attribute is per device: set it at every launch (the launch may be
    // the first on this device).
    const cudaError_t attr = cudaFuncSetAttribute(
        conv3x3_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (attr != cudaSuccess) return (int)attr;
    dim3 grid(tiles, Fp / kBN, n_outer * n_inner);
    conv3x3_bf16_kernel<<<grid, kThreads, kSmemBytes, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wp),
        static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), g);
  } else {
    dim3 grid(tiles, Fp / kFBN, n_outer * n_inner);
    conv3x3_fp32_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(wp),
        static_cast<const float*>(bias), static_cast<float*>(out), g);
  }
  return (int)cudaGetLastError();
}
