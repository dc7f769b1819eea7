// Disparity lookup over the geometry and all-pairs correlation pyramids,
// all levels in one launch.
//
// Replaces the TPU kernel foundationstereo_tpu/ops/pallas_kernels.py:
// lookup_level_pallas (_lookup_row_kernel, reached from
// disparity_lookup_pallas_pre), together with its all-levels variant
// disparity_lookup_pallas_fused (_lookup_fused_kernel), and, for one width
// shard of the multi-device path, the same kernels under
// disparity_lookup_pallas_sharded (a global x offset per shard).
//
// Level l samples 2r+1 taps by 1-D linear interpolation with zero padding
// outside [0, L-1] (grid_sample, align_corners=True): the geometry volume
// geo_l (B, H, W, C, D_l) at disp / 2^l + k, the correlation corr_l
// (B, H, W, W_l) at (x0 + x - disp) / 2^l + k, k in [-r, r], where x0 is the
// global column of local column 0 (0 on one device; a width shard holds W
// of the left columns, each with the full W_l right axis, so it needs no
// halo, only its offset). The output is the dense (B, L*(C+1)*(2r+1), H, W)
// feature map in the channel order [geo_l0 (C-major, taps fastest), corr_l0,
// geo_l1, ...], fp32 accumulation.
//
// Bound on the H100: bytes (about 20 FLOP per output value). The TPU kernel
// contracts a tent over the whole D axis; here a direct gather reads only
// what the taps touch: all taps share one fractional part, so one thread
// reads the 2r+2 consecutive values of its (pixel, channel) row -- contiguous
// in this layout -- and writes 2r+1 outputs. Threads along x are adjacent
// pixels, so the writes are coalesced; the gathered reads are not, which is
// what a later version can improve (stage rows through shared memory).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 8;

struct LookupArgs {
  const void* geo[kMaxLevels];
  const void* corr[kMaxLevels];
  int geo_len[kMaxLevels];
  int corr_len[kMaxLevels];
  int n_levels, C, H, W, radius, x_offset;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename TI>
__device__ __forceinline__ float fetch(const TI* row, int i, int len) {
  return (i >= 0 && i < len) ? to_f(row[i]) : 0.f;
}

template <typename TI, typename TO>
__global__ void lookup_kernel(LookupArgs a, const float* __restrict__ disp,
                              TO* __restrict__ out) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  const int item = blockIdx.y * blockDim.y + threadIdx.y;  // level * (C+1) + channel
  const int bh = blockIdx.z;
  if (w >= a.W || item >= a.n_levels * (a.C + 1)) return;
  const int lvl = item / (a.C + 1), c = item % (a.C + 1);
  const int K = 2 * a.radius + 1;
  const size_t pix = (size_t)bh * a.W + w;
  const float dsp = disp[pix];
  const float scale = ldexpf(1.f, -lvl);

  const TI* row;
  int len;
  float x;
  if (c < a.C) {
    len = a.geo_len[lvl];
    row = static_cast<const TI*>(a.geo[lvl]) + (pix * a.C + c) * len;
    x = dsp * scale;
  } else {
    len = a.corr_len[lvl];
    row = static_cast<const TI*>(a.corr[lvl]) + pix * len;
    x = ((float)(w + a.x_offset) - dsp) * scale;
  }
  // Far-out positions sample zeros either way; the clamp keeps the int finite.
  const float lim = (float)(len + 2 * a.radius + 2);
  x = fminf(fmaxf(x, -lim), lim);
  const float x0 = floorf(x);
  const float f = x - x0;
  const int i0 = (int)x0;

  const int b = bh / a.H, h = bh % a.H;
  const int F = a.n_levels * (a.C + 1) * K;
  const int ch = lvl * (a.C + 1) * K + c * K;
  TO* dst = out + (((size_t)b * F + ch) * a.H + h) * a.W + w;
  const size_t cstride = (size_t)a.H * a.W;
  float prev = fetch(row, i0 - a.radius, len);
  for (int k = -a.radius; k <= a.radius; ++k) {
    const float next = fetch(row, i0 + k + 1, len);
    dst[(size_t)(k + a.radius) * cstride] = from_f<TO>(prev * (1.f - f) + next * f);
    prev = next;
  }
}

template <typename TI, typename TO>
int launch(const LookupArgs& a, const void* disp, void* out, int B, cudaStream_t stream) {
  dim3 block(32, 8);
  dim3 grid((a.W + 31) / 32, (a.n_levels * (a.C + 1) + 7) / 8, B * a.H);
  lookup_kernel<TI, TO><<<grid, block, 0, stream>>>(a, static_cast<const float*>(disp),
                                                    static_cast<TO*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// geo[l]: (B, H, W, C, geo_len[l]); corr[l]: (B, H, W, corr_len[l]), both in
// the input type (fp32 or bf16); disp (B, H, W) fp32; out (B, F, H, W) in
// the output type; x_offset the global column of local column 0. Returns
// cudaGetLastError() after the launch.
extern "C" int fs_disparity_lookup(const void* const* geo, const void* const* corr,
                                   const int* geo_len, const int* corr_len, int n_levels,
                                   const void* disp, void* out, int B, int H, int W, int C,
                                   int radius, int x_offset, int in_bf16, int out_bf16,
                                   void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  LookupArgs a;
  for (int i = 0; i < n_levels; ++i) {
    a.geo[i] = geo[i];
    a.corr[i] = corr[i];
    a.geo_len[i] = geo_len[i];
    a.corr_len[i] = corr_len[i];
  }
  a.n_levels = n_levels;
  a.C = C;
  a.H = H;
  a.W = W;
  a.radius = radius;
  a.x_offset = x_offset;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16 && out_bf16) return launch<__nv_bfloat16, __nv_bfloat16>(a, disp, out, B, s);
  if (in_bf16) return launch<__nv_bfloat16, float>(a, disp, out, B, s);
  if (out_bf16) return launch<float, __nv_bfloat16>(a, disp, out, B, s);
  return launch<float, float>(a, disp, out, B, s);
}
