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
// what the taps touch: all taps share one fractional part, so a (pixel,
// channel) needs the 2r+2 consecutive values of its row, contiguous in this
// layout. The rows of neighbouring pixels lie C * D_l values apart, so no
// two threads share a window and the floor is the card's 32-byte sectors
// that the windows touch. The design:
//
// - each window is read as the few 16-byte-aligned vectors that overlap it
//   (at most 3 for r = 4 in bf16, whatever the row's length or alignment),
//   all issued before any is used; the taps are then selected in registers
//   by a barrel shift over the loaded words. A vector that only overlaps
//   the window outside [0, L) is not loaded; the bytes of a neighbouring row
//   that a loaded vector brings are masked. (A 16-byte-aligned vector that
//   holds one byte of a tensor lies inside its allocation.)
// - the radius is a template parameter for r = 4, the radius of every path
//   the model drives, so its 10 values and 9 taps unroll into registers;
//   any other r runs the generic instantiation of the same kernel, which
//   takes the radius at run time and walks the taps in chunks of 8 (9
//   values each, loaded the same way);
// - each thread serves 2 adjacent pixels (flattened over H x W, so a shard's
//   80 columns leave no thread idle) of one (level, channel) item and writes
//   each tap of both as one bf16x2 / float2 store: a warp writes 128
//   contiguous bytes (bf16) of each output plane;
// - the grid is (items, pixel pairs / 128, B), items fastest: the blocks in
//   flight at one time read all channels and levels of a run of pixels, so
//   the scattered windows fall in a few contiguous megabytes of each volume
//   (DRAM pages and L2 lines shared) instead of one channel's rows across
//   the whole volume; 26,680 blocks of 128 threads at the main shape, 6,728
//   for an 80-column shard.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kChunk = 8;     // taps per chunk of the generic radius
constexpr int kThreads = 128;
constexpr int kPixels = 2;  // adjacent pixels per thread

struct LookupArgs {
  const void* geo[kMaxLevels];
  const void* corr[kMaxLevels];
  int geo_len[kMaxLevels];
  int corr_len[kMaxLevels];
  int n_levels, C, H, W, HW, F, x_offset, pairs_aligned;
};

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// w[k] = w[k + B] for every k where ``on`` (one stage of a barrel shift;
// static indices only, so w stays in registers).
template <int B, int NW>
__device__ __forceinline__ void shift_words(uint32_t (&w)[NW], bool on) {
#pragma unroll
  for (int k = 0; k + B < NW; ++k) w[k] = on ? w[k + B] : w[k];
}

// v[t] = row[s + t] for t in [0, n), 0 where s + t lies outside [0, len)
// (n <= N; v[t] for t >= n is not defined).
template <typename T, int N>
__device__ __forceinline__ void load_window(const T* row, int len, int s, int n, float (&v)[N]) {
  constexpr int E = 16 / sizeof(T);        // elements per 16-byte vector
  constexpr int NC = (N + E - 1) / E + 1;  // vectors a window can overlap
  constexpr int NW = 4 * NC;               // their 32-bit words
  uint32_t w[NW];
  const uintptr_t start = reinterpret_cast<uintptr_t>(row) + (intptr_t)s * (intptr_t)sizeof(T);
  const uintptr_t base = start & ~(uintptr_t)15;
  const int o = (int)(start - base) / (int)sizeof(T);  // the window's offset in its first vector
  const int lo = max(s, 0), hi = min(s + n, len);       // its part inside the row
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int e0 = s - o + j * E;  // the vector's first element, relative to the row
    uint4 q = make_uint4(0u, 0u, 0u, 0u);
    if (e0 < hi && e0 + E > lo) q = __ldg(reinterpret_cast<const uint4*>(base + 16 * j));
    w[4 * j] = q.x;
    w[4 * j + 1] = q.y;
    w[4 * j + 2] = q.z;
    w[4 * j + 3] = q.w;
  }
  // Barrel shift by the offset's whole words (0..3), then, in bf16, by its
  // odd half word: afterwards element t of the window is half t of the words.
  const int ow = o * (int)sizeof(T) / 4;
  shift_words<1>(w, (ow & 1) != 0);
  shift_words<2>(w, (ow & 2) != 0);
  if (sizeof(T) == 2) {
    const int sh = (o & 1) * 16;
#pragma unroll
    for (int k = 0; k + 1 < NW; ++k) w[k] = __funnelshift_r(w[k], w[k + 1], sh);
  }
#pragma unroll
  for (int t = 0; t < N; ++t) {
    float x;
    if (sizeof(T) == 2)
      x = __uint_as_float((t & 1) ? (w[t >> 1] & 0xffff0000u) : (w[t >> 1] << 16));
    else
      x = __uint_as_float(w[t]);
    v[t] = (s + t >= 0 && s + t < len) ? x : 0.f;
  }
}

// Taps k0 .. k0 + nk - 1 (nk <= N - 1) of both pixels: the N values from
// s[i] + k0 of each pixel's row, then one (paired) store per tap.
template <typename TI, typename TO, int N>
__device__ __forceinline__ void gather_taps(const TI* const (&row)[kPixels], int len,
                                            const int (&s)[kPixels], const float (&f)[kPixels],
                                            int k0, int nk, TO* dst, size_t plane, bool pair,
                                            int np) {
  float v[kPixels][N];
#pragma unroll
  for (int i = 0; i < kPixels; ++i) load_window<TI, N>(row[i], len, s[i] + k0, nk + 1, v[i]);
#pragma unroll
  for (int k = 0; k < N - 1; ++k) {
    if (k >= nk) break;
    const float o0 = v[0][k] * (1.f - f[0]) + v[0][k + 1] * f[0];
    const float o1 = v[1][k] * (1.f - f[1]) + v[1][k + 1] * f[1];
    TO* p = dst + (size_t)(k0 + k) * plane;
    if (pair) {
      store2(p, o0, o1);
    } else {
      p[0] = from_f<TO>(o0);
      if (np == kPixels) p[1] = from_f<TO>(o1);
    }
  }
}

// R >= 0: the radius R, unrolled; R < 0: the radius ``radius``, in chunks.
template <typename TI, typename TO, int R>
__global__ void __launch_bounds__(kThreads)
lookup_kernel(LookupArgs a, int radius, const float* __restrict__ disp, TO* __restrict__ out) {
  if constexpr (R >= 0) radius = R;
  const int K = 2 * radius + 1;
  const int q0 = (blockIdx.y * kThreads + threadIdx.x) * kPixels;  // first pixel in the image
  if (q0 >= a.HW) return;
  const int item = blockIdx.x;  // level * (C+1) + channel; channel C is the correlation
  const int lvl = item / (a.C + 1), c = item % (a.C + 1);
  const int b = blockIdx.z;
  const bool geo = c < a.C;
  // The level's volume and length, picked with static indices (a runtime
  // index into the parameter arrays would copy them to local memory).
  int len = 0;
  const TI* vol = nullptr;
#pragma unroll
  for (int i = 0; i < kMaxLevels; ++i)
    if (i == lvl) {
      len = geo ? a.geo_len[i] : a.corr_len[i];
      vol = static_cast<const TI*>(geo ? a.geo[i] : a.corr[i]);
    }
  const float scale = ldexpf(1.f, -lvl);
  // Far-out positions sample zeros either way; the clamp keeps the int finite.
  const float lim = (float)(len + 2 * radius + 2);
  const int np = min(kPixels, a.HW - q0);

  const TI* row[kPixels];
  int s[kPixels];
  float f[kPixels];
#pragma unroll
  for (int i = 0; i < kPixels; ++i) {
    const int q = min(q0 + i, a.HW - 1);  // a pixel past the image repeats the last (not stored)
    const size_t pix = (size_t)b * a.HW + q;
    const float dsp = disp[pix];
    float x = geo ? dsp * scale : ((float)(q % a.W + a.x_offset) - dsp) * scale;
    x = fminf(fmaxf(x, -lim), lim);
    const float x0 = floorf(x);
    f[i] = x - x0;
    s[i] = (int)x0 - radius;
    row[i] = vol + (geo ? pix * a.C + c : pix) * (size_t)len;
  }

  TO* dst = out + ((size_t)b * a.F + (size_t)lvl * (a.C + 1) * K + (size_t)c * K) * a.HW + q0;
  const bool pair = np == kPixels && a.pairs_aligned;
  if constexpr (R >= 0) {
    gather_taps<TI, TO, 2 * R + 2>(row, len, s, f, 0, K, dst, a.HW, pair, np);
  } else {
    for (int k0 = 0; k0 < K; k0 += kChunk)
      gather_taps<TI, TO, kChunk + 1>(row, len, s, f, k0, min(kChunk, K - k0), dst, a.HW, pair,
                                      np);
  }
}

template <typename TI, typename TO>
int launch(const LookupArgs& a, int radius, const void* disp, void* out, dim3 grid,
           cudaStream_t s) {
  const float* d = static_cast<const float*>(disp);
  TO* o = static_cast<TO*>(out);
  if (radius == 4)
    lookup_kernel<TI, TO, 4><<<grid, kThreads, 0, s>>>(a, radius, d, o);
  else
    lookup_kernel<TI, TO, -1><<<grid, kThreads, 0, s>>>(a, radius, d, o);
  return (int)cudaGetLastError();
}

}  // namespace

// geo[l]: (B, H, W, C, geo_len[l]); corr[l]: (B, H, W, corr_len[l]), both in
// the input type (fp32 or bf16); disp (B, H, W) fp32; out (B, F, H, W) in
// the output type; x_offset the global column of local column 0; radius
// >= 0. Writes the launched grid (x, y, z), the threads per block, the
// pixels per thread and the radius to launched[0..5]. Returns
// cudaGetLastError() after the launch.
extern "C" int fs_disparity_lookup(const void* const* geo, const void* const* corr,
                                   const int* geo_len, const int* corr_len, int n_levels,
                                   const void* disp, void* out, int B, int H, int W, int C,
                                   int radius, int x_offset, int in_bf16, int out_bf16,
                                   int* launched, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || radius < 0)
    return (int)cudaErrorInvalidValue;
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
  a.HW = H * W;
  a.F = n_levels * (C + 1) * (2 * radius + 1);
  a.x_offset = x_offset;
  a.pairs_aligned = (a.HW % kPixels == 0) && (reinterpret_cast<uintptr_t>(out) % 8 == 0);
  const int pairs = (a.HW + kPixels - 1) / kPixels;
  const dim3 grid(n_levels * (C + 1), (pairs + kThreads - 1) / kThreads, B);
  const int report[6] = {(int)grid.x, (int)grid.y, (int)grid.z, kThreads, kPixels, radius};
  for (int i = 0; i < 6; ++i) launched[i] = report[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16 && out_bf16) return launch<__nv_bfloat16, __nv_bfloat16>(a, radius, disp, out, grid, s);
  if (in_bf16) return launch<__nv_bfloat16, float>(a, radius, disp, out, grid, s);
  if (out_bf16) return launch<float, __nv_bfloat16>(a, radius, disp, out, grid, s);
  return launch<float, float>(a, radius, disp, out, grid, s);
}
