// Cost-volume parts (gwc + shifted right projection) for the NCDHW CorrStem.
//
// Replaces the TPU kernels foundationstereo_tpu/ops/pallas_kernels.py:
// build_cost_volume_pallas -> _cost_volume_rows -> _cost_volume_row_kernel
// (return_parts / out5d form), and, for one width shard of the multi-device
// path, build_cost_volume_pallas_sharded -> _cost_volume_row_kernel_haloed.
//
//   gwc[b, g, d, h, w] = sum_c Ln[b, g*cg + c, h, w] * Rn[b, g*cg + c, h, x0 + w - d]
//   rps[b, p, d, h, w] = rp[b, p, h, x0 + w - d]      (both 0 where x0 + w < d)
//
// with Ln / Rn the features L2-normalised within each group of cg channels
// (the normalisation is folded in here, in fp32, like group_normalize). The
// left features and the outputs hold W columns; the right features and the
// projection hold WR columns. The single-device build (K1) is x0 = 0,
// WR = W. A width shard (K5) holds the W = W_local left columns at global
// offset x0 and reads the full-width right rows at x0 + w - d, which reach up
// to D - 1 columns into the shards to its left (the halo; zeros left of
// column 0). Every output element is the same arithmetic in the same order
// (fp32 FMAs over c = 0..cg-1, whatever the tile, block or shard), so the
// stitched shards equal the single-device build bit for bit.
//
// Bound on the H100: bytes, with the products close behind. Writing the
// bf16 parts (~245 MB at the main path's shapes) takes ~0.073 ms at
// 3.35 TB/s; the gwc dot products are 2*cg FLOP per output value (~2.7
// GFLOP, ~0.04 ms at the fp32 peak). So the design keeps the FMA pipe fed
// from registers and writes every output once with 16-byte stores:
//
// - a block serves one (b, h) row, one group g (or one projection channel
//   p) and a tile of WT = 8 * nwt output columns (``nwt`` from the wrapper:
//   4 tiles of 80 columns at W = 320, one at a shard's 80);
// - it first normalises the WT left columns and the 8 * ndt + WT right
//   columns its outputs read (ndt = ceil(D / 8)) into shared memory, each
//   thread one column with all cg loads issued before any is used (cg is a
//   template parameter: 28 on the main path, a generic <= 32 otherwise);
// - each thread then owns a register tile of 8 consecutive w x 8
//   consecutive d (nwt x ndt tiles per block): per channel it reads its 8
//   left values and the 15 right values of the tile's diagonals (two and
//   four 16-byte shared loads, conflict-free: ``interleaved``) for 64 FMAs,
//   and stores each d's 8 outputs as one 16-byte vector (a warp writes
//   whole 128-byte lines along w); a tile wholly left of column 0 skips its
//   products;
// - a projection block copies its shifted row the same way: the row in
//   shared memory, 8 outputs of one d per 16-byte store;
// - blocks of at most 160 threads, 4 to an SM (96 registers a thread): a
//   block's load, product and store phases run one after another, so the
//   SM overlaps them across its blocks.
// fp32 FMAs throughout: no tensor-core product of rounded normalised values,
// which could move gwc by more than the 1-ulp tolerance against its twin.
// The products are the larger part of the time on the H100: each channel
// step moves 96 bytes of shared memory per thread for its 64 FMAs, so the
// SM's shared-memory bandwidth, not the FMA pipe, bounds that phase.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCg = 32;
constexpr int kMaxThreads = 160;  // 4 blocks of 160 threads fit an SM's registers
constexpr int kTileW = 8;  // output columns per thread tile
constexpr int kTileD = 8;  // disparities per thread tile

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// The 8 values v[0..7] at p[0..7]: one 16-byte store (bf16) or two (fp32)
// where ``vec``, else one store per value below ``n``.
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8], bool vec, int n) {
  if (vec) {
    uint32_t q[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      q[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(q[0], q[1], q[2], q[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < n) p[i] = __float2bfloat16_rn(v[i]);
  }
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8], bool vec, int n) {
  if (vec) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < n) p[i] = v[i];
  }
}

// The shared-memory position of column j in a row of ``pitch`` (a multiple
// of 8) columns: the even 4-column groups in the first half of the row and
// the odd ones in the second, so the 16-byte loads of a warp's threads (8
// columns each, neighbours 8 apart) are consecutive and free of bank
// conflicts.
__device__ __forceinline__ int interleaved(int j, int pitch) {
  const int g = j >> 2;
  return (g & 1) * (pitch >> 1) + ((g >> 1) << 2) + (j & 3);
}

struct Shape {
  int C, H, W, WR, x0, G, P, D, cg, nwt, ndt;
};

// CG: the channels per group (kMaxCg stands for any cg <= kMaxCg).
template <typename TI, typename TO, int CG>
__global__ void __launch_bounds__(kMaxThreads, 4)
cost_volume_parts_kernel(const TI* __restrict__ left, const TI* __restrict__ right,
                         const TI* __restrict__ rproj, TO* __restrict__ gwc,
                         TO* __restrict__ rps, Shape s) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int cg = CG == kMaxCg ? s.cg : CG;
  const int WT = kTileW * s.nwt;
  const int NR = kTileD * s.ndt + WT;      // right columns [xb, xb + NR) of the tile
  const int wt0 = blockIdx.x * WT;         // the tile's first (local) output column
  const int xb = s.x0 + wt0 - kTileD * s.ndt;
  const int gy = blockIdx.y;
  const int b = blockIdx.z / s.H, h = blockIdx.z % s.H;
  const size_t HW = (size_t)s.H * s.W;     // a plane of the left features and of the outputs
  const size_t HWR = (size_t)s.H * s.WR;   // a plane of the right features and projection
  const bool vec = s.W % 8 == 0;           // every 8-column group is 16-byte aligned

  if (gy >= s.G) {  // shifted right projection, channel p
    const int p = gy - s.G;
    const TI* src = rproj + ((size_t)b * s.P + p) * HWR + (size_t)h * s.WR;
    for (int j = threadIdx.x; j < NR; j += blockDim.x) {
      const int x = xb + j;
      smem[j] = (x >= 0 && x < s.WR) ? to_f(src[x]) : 0.f;
    }
    __syncthreads();
    TO* dst = rps + ((size_t)b * s.P + p) * s.D * HW + (size_t)h * s.W + wt0;
    for (int it = threadIdx.x; it < s.D * s.nwt; it += blockDim.x) {
      const int d = it / s.nwt, w0 = kTileW * (it % s.nwt);
      const int n = min(kTileW, s.W - wt0 - w0);
      if (n <= 0) continue;
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = smem[kTileD * s.ndt + w0 + i - d];
      store8(dst + (size_t)d * HW + w0, v, vec && n == kTileW, n);
    }
    return;
  }

  // Normalised right columns rn[c][j] (x = xb + j) and left columns
  // ln[c][j] (w = wt0 + j), zero outside the rows.
  float* rn = smem;
  float* ln = smem + (size_t)cg * NR;
  const TI* rsrc = right + ((size_t)b * s.C + (size_t)gy * cg) * HWR + (size_t)h * s.WR;
  const TI* lsrc = left + ((size_t)b * s.C + (size_t)gy * cg) * HW + (size_t)h * s.W;
  for (int j = threadIdx.x; j < NR + WT; j += blockDim.x) {
    const bool is_right = j < NR;
    const int col = is_right ? xb + j : wt0 + j - NR;
    const bool in = is_right ? (col >= 0 && col < s.WR) : col < s.W;
    const TI* src = is_right ? rsrc + col : lsrc + col;
    const size_t stride = is_right ? HWR : HW;
    float v[CG];
#pragma unroll
    for (int c = 0; c < CG; ++c) v[c] = (in && c < cg) ? to_f(src[c * stride]) : 0.f;
    float ss = 0.f;
#pragma unroll
    for (int c = 0; c < CG; ++c) ss = fmaf(v[c], v[c], ss);
    const float nrm = fmaxf(sqrtf(ss), 1e-12f);
    const int pitch = is_right ? NR : WT;
    float* dst = (is_right ? rn : ln) + interleaved(is_right ? j : j - NR, pitch);
#pragma unroll
    for (int c = 0; c < CG; ++c)
      if (c < cg) dst[c * pitch] = v[c] / nrm;
  }
  __syncthreads();

  TO* out = gwc + ((size_t)b * s.G + gy) * s.D * HW + (size_t)h * s.W + wt0;
  for (int it = threadIdx.x; it < s.nwt * s.ndt; it += blockDim.x) {
    const int wt = it % s.nwt, dt = it / s.nwt;
    const int w0 = kTileW * wt, d0 = kTileD * dt;
    const int n = min(kTileW, s.W - wt0 - w0);
    if (n <= 0) continue;
    // Output (w0 + i, d0 + j) reads rn at column m + i - j, m = TD (ndt - dt)
    // + 8 wt with TD = kTileD: r[TD + i - j] with r the TD + 8 columns from
    // m - TD, the 4-column groups from (m - TD) / 4 on (even groups in the
    // first half of the row, odd ones in the second).
    const int gb = (kTileD * (s.ndt - dt) + kTileW * wt - kTileD) / 8;
    constexpr int NG = (kTileD + 8) / 4;  // 4-column groups of right values per tile
    float acc[8][kTileD];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < kTileD; ++j) acc[i][j] = 0.f;
    // A tile whose every output lies left of column 0 (x0 + w < d) is zero:
    // it skips the products (the sum of zero products is +0 either way).
    const int ncg = s.x0 + wt0 + w0 + kTileW - 1 < d0 ? 0 : cg;
    const int half = NR / 8;  // 4-column groups per half row
    const float4* lrow = reinterpret_cast<const float4*>(ln) + wt;
    const float4* rrow = reinterpret_cast<const float4*>(rn) + gb;
#pragma unroll 2
    for (int c = 0; c < ncg; ++c, lrow += WT / 4, rrow += NR / 4) {
      const float4 l0 = lrow[0], l1 = lrow[s.nwt];
      const float lv[8] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
      float r[4 * NG];
#pragma unroll
      for (int q = 0; q < NG; ++q) {
        const float4 v = rrow[(q & 1) * half + (q >> 1)];
        r[4 * q] = v.x;
        r[4 * q + 1] = v.y;
        r[4 * q + 2] = v.z;
        r[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < kTileD; ++j) acc[i][j] = fmaf(lv[i], r[kTileD + i - j], acc[i][j]);
    }
#pragma unroll
    for (int j = 0; j < kTileD; ++j) {
      if (d0 + j >= s.D) break;
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = acc[i][j];
      store8(out + (size_t)(d0 + j) * HW + w0, v, vec && n == kTileW, n);
    }
  }
}

template <typename TI, typename TO, int CG>
int launch_cg(const void* left, const void* right, const void* rproj, void* gwc, void* rps,
              const Shape& s, dim3 grid, int threads, size_t smem, cudaStream_t stream) {
  auto kernel = cost_volume_parts_kernel<TI, TO, CG>;
  if (smem > 48 * 1024) {  // per device: set it at every launch
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const TI*>(left), static_cast<const TI*>(right),
      static_cast<const TI*>(rproj), static_cast<TO*>(gwc), static_cast<TO*>(rps), s);
  return (int)cudaGetLastError();
}

template <typename TI, typename TO>
int launch(const void* left, const void* right, const void* rproj, void* gwc, void* rps,
           const Shape& s, dim3 grid, int threads, size_t smem, cudaStream_t stream) {
  if (s.cg == 28)
    return launch_cg<TI, TO, 28>(left, right, rproj, gwc, rps, s, grid, threads, smem, stream);
  return launch_cg<TI, TO, kMaxCg>(left, right, rproj, gwc, rps, s, grid, threads, smem, stream);
}

}  // namespace

// left (B, C, H, W) holds the global columns [x0, x0 + W); right (B, C, H, WR)
// and rproj (B, P, H, WR) are full width, all in the input type (fp32 or
// bf16); gwc (B, G, D, H, W) and rps (B, P, D, H, W) in the output type. The
// single-device build passes x0 = 0, WR = W. A block serves 8 * nwt output
// columns. Requires C / G <= 32, x0 + W <= WR and nwt * ceil(D / 8) <= 160.
// Writes the launched grid (x, y, z), the threads per block and the block's
// tile (columns, disparities) to launched[0..5]. Returns cudaGetLastError()
// after the launch.
extern "C" int fs_cost_volume_parts_haloed(const void* left, const void* right,
                                           const void* rproj, void* gwc, void* rps, int B,
                                           int C, int H, int W, int WR, int x0, int G, int P,
                                           int D, int nwt, int in_bf16, int out_bf16,
                                           int* launched, void* stream) {
  if (G < 1 || C % G != 0 || C / G > kMaxCg || x0 < 0 || x0 + W > WR || D < 1 || nwt < 1)
    return (int)cudaErrorInvalidValue;
  Shape s{C, H, W, WR, x0, G, P, D, C / G, nwt, (D + kTileD - 1) / kTileD};
  const int items = s.nwt * s.ndt;
  if (items > kMaxThreads) return (int)cudaErrorInvalidValue;
  const int threads = (items + 31) / 32 * 32;
  const int WT = kTileW * nwt, NR = kTileD * s.ndt + WT;
  const size_t smem = (size_t)s.cg * (NR + WT) * sizeof(float);
  const dim3 grid((W + WT - 1) / WT, G + P, B * H);
  const int report[6] = {(int)grid.x, (int)grid.y, (int)grid.z, threads, WT, kTileD * s.ndt};
  for (int i = 0; i < 6; ++i) launched[i] = report[i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_bf16 && out_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(left, right, rproj, gwc, rps, s, grid, threads,
                                                 smem, st);
  if (in_bf16)
    return launch<__nv_bfloat16, float>(left, right, rproj, gwc, rps, s, grid, threads, smem, st);
  if (out_bf16)
    return launch<float, __nv_bfloat16>(left, right, rproj, gwc, rps, s, grid, threads, smem, st);
  return launch<float, float>(left, right, rproj, gwc, rps, s, grid, threads, smem, st);
}
