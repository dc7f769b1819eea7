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
// as in the single-device build, so the stitched shards equal it bit for bit.
//
// Bound on the H100: bytes. The gwc dot products are 2*cg FLOP per output
// value (~2.7 GFLOP per pair at the main-path shapes), far below the
// ~0.1 ms that writing the bf16 parts (~245 MB) takes at 3.35 TB/s. So the
// design reads each input element once and writes each output once,
// coalesced along w: one block per (b, h, group) keeps the normalised right
// columns its outputs read ([max(x0 - D + 1, 0), x0 + W), at most D - 1 + W)
// in shared memory and each thread keeps the normalised left column of one w
// in registers while it sweeps d; blocks with blockIdx.y >= G copy one
// channel of the right projection row per d.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxCg = 32;
constexpr int kThreads = 128;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__host__ __device__ __forceinline__ int window_start(int x0, int D) {
  return x0 - (D - 1) > 0 ? x0 - (D - 1) : 0;
}

template <typename TI, typename TO>
__global__ void __launch_bounds__(kThreads)
cost_volume_parts_kernel(const TI* __restrict__ left, const TI* __restrict__ right,
                         const TI* __restrict__ rproj, TO* __restrict__ gwc,
                         TO* __restrict__ rps, int C, int H, int W, int WR, int x0, int G,
                         int P, int D) {
  extern __shared__ float rn[];  // (cg, WN) normalised right columns [ws, x0 + W) of one group
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int gy = blockIdx.y;
  const size_t HW = (size_t)H * W;    // a plane of the left features and of the outputs
  const size_t HWR = (size_t)H * WR;  // a plane of the right features and projection
  const int ws = window_start(x0, D);
  const int WN = x0 + W - ws;

  if (gy >= G) {  // shifted right projection, channel p
    const int p = gy - G;
    const TI* src = rproj + ((size_t)b * P + p) * HWR + (size_t)h * WR;
    TO* dst = rps + ((size_t)b * P + p) * D * HW + (size_t)h * W;
    for (int d = 0; d < D; ++d)
      for (int w = threadIdx.x; w < W; w += kThreads) {
        const int x = x0 + w - d;
        dst[(size_t)d * HW + w] = from_f<TO>(x >= 0 ? to_f(src[x]) : 0.f);
      }
    return;
  }

  const int cg = C / G;
  const TI* rsrc = right + ((size_t)b * C + (size_t)gy * cg) * HWR + (size_t)h * WR + ws;
  const TI* lsrc = left + ((size_t)b * C + (size_t)gy * cg) * HW + (size_t)h * W;
  for (int j = threadIdx.x; j < WN; j += kThreads) {
    float ss = 0.f;
    for (int c = 0; c < cg; ++c) {
      const float v = to_f(rsrc[c * HWR + j]);
      rn[c * WN + j] = v;
      ss += v * v;
    }
    const float nrm = fmaxf(sqrtf(ss), 1e-12f);
    for (int c = 0; c < cg; ++c) rn[c * WN + j] /= nrm;
  }
  __syncthreads();

  TO* dst = gwc + ((size_t)b * G + gy) * D * HW + (size_t)h * W;
  for (int w = threadIdx.x; w < W; w += kThreads) {
    float ln[kMaxCg];
    float ss = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCg; ++c) {
      ln[c] = c < cg ? to_f(lsrc[c * HW + w]) : 0.f;
      ss += ln[c] * ln[c];
    }
    const float nrm = fmaxf(sqrtf(ss), 1e-12f);
#pragma unroll
    for (int c = 0; c < kMaxCg; ++c) ln[c] /= nrm;
    for (int d = 0; d < D; ++d) {
      const int x = x0 + w - d;
      float acc = 0.f;
      if (x >= 0) {
#pragma unroll
        for (int c = 0; c < kMaxCg; ++c)
          if (c < cg) acc += ln[c] * rn[c * WN + x - ws];
      }
      dst[(size_t)d * HW + w] = from_f<TO>(acc);
    }
  }
}

template <typename TI, typename TO>
int launch(const void* left, const void* right, const void* rproj, void* gwc, void* rps,
           int B, int C, int H, int W, int WR, int x0, int G, int P, int D,
           cudaStream_t stream) {
  const size_t smem = (size_t)(C / G) * (x0 + W - window_start(x0, D)) * sizeof(float);
  auto kernel = cost_volume_parts_kernel<TI, TO>;
  if (smem > 48 * 1024) {  // per device: set it at every launch
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(B * H, G + P);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TI*>(left), static_cast<const TI*>(right),
      static_cast<const TI*>(rproj), static_cast<TO*>(gwc), static_cast<TO*>(rps),
      C, H, W, WR, x0, G, P, D);
  return (int)cudaGetLastError();
}

}  // namespace

// left (B, C, H, W) holds the global columns [x0, x0 + W); right (B, C, H, WR)
// and rproj (B, P, H, WR) are full width, all in the input type (fp32 or
// bf16); gwc (B, G, D, H, W) and rps (B, P, D, H, W) in the output type. The
// single-device build passes x0 = 0, WR = W. Requires C / G <= 32 and
// x0 + W <= WR. Returns cudaGetLastError() after the launch.
extern "C" int fs_cost_volume_parts_haloed(const void* left, const void* right,
                                           const void* rproj, void* gwc, void* rps, int B,
                                           int C, int H, int W, int WR, int x0, int G, int P,
                                           int D, int in_bf16, int out_bf16, void* stream) {
  if (C % G != 0 || C / G > kMaxCg || x0 < 0 || x0 + W > WR) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16 && out_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(left, right, rproj, gwc, rps, B, C, H, W, WR,
                                                 x0, G, P, D, s);
  if (in_bf16)
    return launch<__nv_bfloat16, float>(left, right, rproj, gwc, rps, B, C, H, W, WR, x0, G,
                                        P, D, s);
  if (out_bf16)
    return launch<float, __nv_bfloat16>(left, right, rproj, gwc, rps, B, C, H, W, WR, x0, G,
                                        P, D, s);
  return launch<float, float>(left, right, rproj, gwc, rps, B, C, H, W, WR, x0, G, P, D, s);
}
