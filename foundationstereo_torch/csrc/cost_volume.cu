// Cost-volume parts (gwc + shifted right projection) for the NCDHW CorrStem.
//
// Replaces the TPU kernel foundationstereo_tpu/ops/pallas_kernels.py:
// build_cost_volume_pallas -> _cost_volume_rows -> _cost_volume_row_kernel
// (return_parts / out5d form).
//
//   gwc[b, g, d, h, w] = sum_c Ln[b, g*cg + c, h, w] * Rn[b, g*cg + c, h, w - d]
//   rps[b, p, d, h, w] = rp[b, p, h, w - d]           (both 0 where w < d)
//
// with Ln / Rn the features L2-normalised within each group of cg channels
// (the normalisation is folded in here, in fp32, like group_normalize).
//
// Bound on the H100: bytes. The gwc dot products are 2*cg FLOP per output
// value (~2.7 GFLOP per pair at the main-path shapes), far below the
// ~0.1 ms that writing the bf16 parts (~245 MB) takes at 3.35 TB/s. So the
// design reads each input element once and writes each output once,
// coalesced along w: one block per (b, h, group) keeps the normalised right
// row of its group in shared memory and each thread keeps the normalised
// left column of one w in registers while it sweeps d; blocks with
// blockIdx.y >= G copy one channel of the right projection row per d.
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

template <typename TI, typename TO>
__global__ void __launch_bounds__(kThreads)
cost_volume_parts_kernel(const TI* __restrict__ left, const TI* __restrict__ right,
                         const TI* __restrict__ rproj, TO* __restrict__ gwc,
                         TO* __restrict__ rps, int C, int H, int W, int G, int P,
                         int D) {
  extern __shared__ float rn[];  // (cg, W) normalised right row of one group
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int gy = blockIdx.y;
  const size_t HW = (size_t)H * W;
  const size_t row = (size_t)h * W;

  if (gy >= G) {  // shifted right projection, channel p
    const int p = gy - G;
    const TI* src = rproj + ((size_t)b * P + p) * HW + row;
    TO* dst = rps + ((size_t)b * P + p) * D * HW + row;
    for (int d = 0; d < D; ++d)
      for (int w = threadIdx.x; w < W; w += kThreads)
        dst[(size_t)d * HW + w] = from_f<TO>(w >= d ? to_f(src[w - d]) : 0.f);
    return;
  }

  const int cg = C / G;
  const TI* rsrc = right + ((size_t)b * C + (size_t)gy * cg) * HW + row;
  const TI* lsrc = left + ((size_t)b * C + (size_t)gy * cg) * HW + row;
  for (int w = threadIdx.x; w < W; w += kThreads) {
    float ss = 0.f;
    for (int c = 0; c < cg; ++c) {
      const float v = to_f(rsrc[c * HW + w]);
      rn[c * W + w] = v;
      ss += v * v;
    }
    const float nrm = fmaxf(sqrtf(ss), 1e-12f);
    for (int c = 0; c < cg; ++c) rn[c * W + w] /= nrm;
  }
  __syncthreads();

  TO* dst = gwc + ((size_t)b * G + gy) * D * HW + row;
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
      float acc = 0.f;
      if (w >= d) {
#pragma unroll
        for (int c = 0; c < kMaxCg; ++c)
          if (c < cg) acc += ln[c] * rn[c * W + w - d];
      }
      dst[(size_t)d * HW + w] = from_f<TO>(acc);
    }
  }
}

template <typename TI, typename TO>
int launch(const void* left, const void* right, const void* rproj, void* gwc, void* rps,
           int B, int C, int H, int W, int G, int P, int D, cudaStream_t stream) {
  const size_t smem = (size_t)(C / G) * W * sizeof(float);
  auto kernel = cost_volume_parts_kernel<TI, TO>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid(B * H, G + P);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TI*>(left), static_cast<const TI*>(right),
      static_cast<const TI*>(rproj), static_cast<TO*>(gwc), static_cast<TO*>(rps),
      C, H, W, G, P, D);
  return (int)cudaGetLastError();
}

}  // namespace

// left/right (B, C, H, W), rproj (B, P, H, W) in the input type (fp32 or
// bf16); gwc (B, G, D, H, W) and rps (B, P, D, H, W) in the output type.
// Requires C / G <= 32. Returns cudaGetLastError() after the launch.
extern "C" int fs_cost_volume_parts(const void* left, const void* right, const void* rproj,
                                    void* gwc, void* rps, int B, int C, int H, int W,
                                    int G, int P, int D, int in_bf16, int out_bf16,
                                    void* stream) {
  if (C % G != 0 || C / G > kMaxCg) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16 && out_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(left, right, rproj, gwc, rps, B, C, H, W, G, P, D, s);
  if (in_bf16)
    return launch<__nv_bfloat16, float>(left, right, rproj, gwc, rps, B, C, H, W, G, P, D, s);
  if (out_bf16)
    return launch<float, __nv_bfloat16>(left, right, rproj, gwc, rps, B, C, H, W, G, P, D, s);
  return launch<float, float>(left, right, rproj, gwc, rps, B, C, H, W, G, P, D, s);
}
