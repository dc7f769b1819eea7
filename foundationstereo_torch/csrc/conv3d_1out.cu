// Direct 3D convolution to one output channel: the classifier's last conv
// (models/cost_filter.py:Classifier, 14 -> 1 channels, 7x7x7, stride 1,
// padding 3), which turns the filtered volume into the (B, D, H, W) logits.
//
// Replaces no TPU kernel: the JAX package has no Pallas kernel for this conv
// and leaves it to XLA (foundationstereo_tpu/models/cost_filter.py:
// Classifier). It was added because cuDNN runs the bf16 conv as an fp32
// implicit GEMM whose tile is wide in output channels and here has one:
// 95 ms per 736x1280 pair on the H100, more than 100x its FMA bound.
//
//   out[b, d, h, w] = bias + sum_{c, i, j, k} x[b, c, d + i - pd, h + j - ph, w + k - pw]
//                                              * wt[c, i, j, k]
//
// with x zero outside the volume, i, j, k in [0, K) and K odd (3, 5 or 7).
// The input is fp32 (the classifier's volume comes out of a batch norm in
// fp32). Operands are rounded to the compute type Tc (the weight's and the
// output's, bf16 or fp32) as they are loaded: under a bf16 weight the input
// is rounded to bf16 on its way into shared memory, so no rounded copy of
// the volume is made. Products and sums are fp32 FMAs (exact
// products of bf16 operands; no TF32), the bias is added in fp32 and the
// sum is rounded once to Tc.
//
// Bound on the H100, at the cells' shape (B = 1, C = 14, D = 104, H = 184,
// W = 320, K = 7: 6,123,520 outputs of C K^3 = 4802 FMAs): operations.
// 58.8 GFLOP take 0.88 ms at the 67 TF/s of fp32 FMAs (0.06 ms at the bf16
// tensor peak, which the fp32 sums rule out); the bytes, 343 MB of fp32
// input and 12 MB of bf16 output, take 0.11 ms. So the design keeps the FMA
// pipe fed from registers and shared memory:
//
// - a block of 256 threads owns an output tile of 8 (d) x 16 (h) x 64 (w);
//   per input channel it stages the tile's input with its K - 1 halo (14 x
//   22 x 70 values at K = 7, fp32, zero outside the volume) and the
//   channel's K^3 weights in shared memory (90 KB at K = 7: 2 blocks per
//   SM);
// - a warp owns one output depth d (all its threads read the same weights:
//   broadcast loads) and 16 column strips x 2 row groups; a thread owns 8
//   rows x 4 consecutive columns (32 accumulators);
// - for each depth tap i the thread holds the K x K weights of (c, i) in
//   registers (49 at K = 7) and walks the 8 + K - 1 input rows its outputs
//   read: each row's 4 + K - 1 values come in as 16-byte loads (a quarter
//   warp reads 128 contiguous bytes: no bank conflicts) and feed up to K
//   output rows x K taps x 4 columns, 4 x 49 x 8 = 1568 FMAs per 14 rows of
//   3 loads, so the shared-memory pipe stays under half busy when the FMA
//   pipe is full.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // 8 warps
constexpr int kTileD = 8;              // output depths per block: one per warp
constexpr int kRows = 8;               // output rows per thread
constexpr int kRowGroups = 2;          // row groups per warp
constexpr int kTileH = kRows * kRowGroups;  // 16 output rows per block
constexpr int kVec = 4;                // output columns per thread
constexpr int kStrips = 16;            // column strips per warp
constexpr int kTileW = kVec * kStrips;      // 64 output columns per block

template <int K>
struct Tile {
  static constexpr int kPlanes = kTileD + K - 1;         // staged depths
  static constexpr int kRowsIn = kTileH + K - 1;         // staged rows per depth
  static constexpr int kCols = kTileW + K - 1;           // staged columns per row
  static constexpr int kLoads = (kVec + K - 1 + 3) / 4;  // 16-byte loads per input row
  // A row's pitch: a multiple of 4 (16-byte loads), wide enough for the last
  // strip's loads (whose values past kCols are never used).
  static constexpr int kPitch0 = (kCols + 3) / 4 * 4;
  static constexpr int kPitch = kPitch0 > 4 * (kStrips - 1 + kLoads) ? kPitch0
                                                                       : 4 * (kStrips - 1 + kLoads);
  static constexpr int kPlane = kRowsIn * kPitch;
  static constexpr int kIn = kPlanes * kPlane;           // staged values per channel
  static constexpr int kWRow = (K + 3) / 4 * 4;          // a weight row (k) padded to 16 bytes
  static constexpr int kW = K * K * kWRow;               // staged weights per channel
  static constexpr size_t kSmem = (size_t)(kIn + kW) * sizeof(float);
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// v rounded to the compute type (bf16: to nearest even), as a float.
template <typename Tc>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The 4 outputs v[0..3] at p[0..3]: one vector store where ``vec``, else one
// store per value below ``n``.
__device__ __forceinline__ void store4(float* p, const float (&v)[4], bool vec, int n) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < n) p[j] = v[j];
  }
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4], bool vec, int n) {
  if (vec) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&a), *reinterpret_cast<const uint32_t*>(&b));
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < n) p[j] = __float2bfloat16_rn(v[j]);
  }
}

struct Shape {
  int C, D, H, W;        // input
  int Do, Ho, Wo;        // output
  int pd, ph, pw;        // zero padding
  long long sb, sc, sd, sh;  // input strides (elements); W's is 1
};

template <typename Tc, int K>
__global__ void __launch_bounds__(kThreads, 2)
conv3d_1out_kernel(const float* __restrict__ x, const Tc* __restrict__ wt,
                   const Tc* __restrict__ bias, Tc* __restrict__ out, Shape s) {
  using T = Tile<K>;
  extern __shared__ float4 smem4[];
  float* s_in = reinterpret_cast<float*>(smem4);
  float* s_w = s_in + T::kIn;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int strip = lane & (kStrips - 1), group = lane / kStrips;
  const int w0 = blockIdx.x * kTileW, h0 = blockIdx.y * kTileH;
  const int dtiles = (s.Do + kTileD - 1) / kTileD;
  const int b = blockIdx.z / dtiles, d0 = (blockIdx.z % dtiles) * kTileD;
  const float* xb = x + b * s.sb;

  float acc[kRows][kVec];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[r][j] = 0.f;

  // The thread's first input value of each staged depth: its warp's depth,
  // its row group's first row, its strip's first column.
  const float* base = s_in + warp * T::kPlane + group * kRows * T::kPitch + strip * kVec;

  for (int c = 0; c < s.C; ++c) {
    __syncthreads();  // the previous channel's products are done with shared memory
    const Tc* wc = wt + (size_t)c * K * K * K;
    for (int i = tid; i < K * K * K; i += kThreads) {
      const int k = i % K;
      s_w[(i / K) * T::kWRow + k] = to_f(wc[i]);
    }
    // One staged row (depth z, row y) per warp at a time, its columns over
    // the lanes: coalesced loads along W. Both blocks of an SM stage at the
    // same time, so the loads' latency is exposed: 8 rows unrolled keep 24
    // loads of a thread in flight (on the H100 at the classifier's shape,
    // 1.70 ms against 2.03 with 4 rows and 1.70 with 1, bf16; fp32 1.43).
    const float* xc = xb + c * s.sc;
#pragma unroll 8
    for (int row = warp; row < T::kPlanes * T::kRowsIn; row += kThreads / 32) {
      const int z = row / T::kRowsIn, y = row - z * T::kRowsIn;
      const int gz = d0 + z - s.pd, gy = h0 + y - s.ph;
      const bool in = gz >= 0 && gz < s.D && gy >= 0 && gy < s.H;
      const long long off = in ? gz * s.sd + gy * s.sh : 0;
      float* dst = s_in + z * T::kPlane + y * T::kPitch;
#pragma unroll
      for (int q = 0; q < (T::kCols + 31) / 32; ++q) {
        const int col = lane + 32 * q;
        const int gx = w0 + col - s.pw;
        float v = 0.f;
        if (in && gx >= 0 && gx < s.W) v = round_to<Tc>(xc[off + gx]);
        if (col < T::kCols) dst[col] = v;
      }
    }
    __syncthreads();

#pragma unroll 1
    for (int i = 0; i < K; ++i) {
      float w[K][K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float4* src = reinterpret_cast<const float4*>(s_w + (i * K + j) * T::kWRow);
#pragma unroll
        for (int q = 0; q < T::kWRow / 4; ++q) {
          const float4 t = src[q];
          const float tv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (4 * q + e < K) w[j][4 * q + e] = tv[e];
        }
      }
      const float* plane = base + i * T::kPlane;
#pragma unroll
      for (int r = 0; r < kRows + K - 1; ++r) {
        float v[4 * T::kLoads];
        const float4* src = reinterpret_cast<const float4*>(plane + r * T::kPitch);
#pragma unroll
        for (int q = 0; q < T::kLoads; ++q) {
          const float4 t = src[q];
          v[4 * q] = t.x;
          v[4 * q + 1] = t.y;
          v[4 * q + 2] = t.z;
          v[4 * q + 3] = t.w;
        }
        // Input row r feeds output row o through the row tap j = r - o.
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const int o = r - j;
          if (o >= 0 && o < kRows) {
#pragma unroll
            for (int k = 0; k < K; ++k)
#pragma unroll
              for (int e = 0; e < kVec; ++e) acc[o][e] = fmaf(v[e + k], w[j][k], acc[o][e]);
          }
        }
      }
    }
  }

  const int d = d0 + warp;
  if (d >= s.Do) return;
  const float bv = bias ? to_f(bias[0]) : 0.f;
  const int wq = w0 + strip * kVec;
  const int n = s.Wo - wq;
  if (n <= 0) return;
#pragma unroll
  for (int o = 0; o < kRows; ++o) {
    const int h = h0 + group * kRows + o;
    if (h < s.Ho) {
      Tc* p = out + ((size_t)(b * s.Do + d) * s.Ho + h) * s.Wo + wq;
      const bool vec = n >= kVec && reinterpret_cast<uintptr_t>(p) % (kVec * sizeof(Tc)) == 0;
      const float v[4] = {acc[o][0] + bv, acc[o][1] + bv, acc[o][2] + bv, acc[o][3] + bv};
      store4(p, v, vec, n);
    }
  }
}

template <typename Tc, int K>
int launch(const void* x, const void* wt, const void* bias, void* out, const Shape& s, int B,
           int* launched, cudaStream_t stream) {
  using T = Tile<K>;
  auto kernel = conv3d_1out_kernel<Tc, K>;
  // The attribute is per device: set it at every launch.
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s.Wo + kTileW - 1) / kTileW, (s.Ho + kTileH - 1) / kTileH,
                  (s.Do + kTileD - 1) / kTileD * B);
  const int report[7] = {(int)grid.x, (int)grid.y, (int)grid.z, kThreads, kTileD, kTileH, kTileW};
  for (int i = 0; i < 7; ++i) launched[i] = report[i];
  kernel<<<grid, kThreads, T::kSmem, stream>>>(
      static_cast<const float*>(x), static_cast<const Tc*>(wt), static_cast<const Tc*>(bias),
      static_cast<Tc*>(out), s);
  return (int)cudaGetLastError();
}

template <typename Tc>
int launch_k(const void* x, const void* wt, const void* bias, void* out, const Shape& s, int B,
             int K, int* launched, cudaStream_t stream) {
  if (K == 7) return launch<Tc, 7>(x, wt, bias, out, s, B, launched, stream);
  if (K == 5) return launch<Tc, 5>(x, wt, bias, out, s, B, launched, stream);
  if (K == 3) return launch<Tc, 3>(x, wt, bias, out, s, B, launched, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (B, C, D, H, W) in fp32 with strides (sb, sc, sd, sh) and unit stride
// along W; wt (1, C, K, K, K) contiguous and bias
// (1,) or null in the compute type (bf16 or fp32), which is also the type of
// out (B, Do, Ho, Wo), contiguous, Do = D + 2 pd - K + 1 and so on. K is 3,
// 5 or 7. Writes the launched grid (x, y, z), the threads per block and the
// block's output tile (depths, rows, columns) to launched[0..6]. Returns
// cudaGetLastError() after the launch.
extern "C" int fs_conv3d_1out(const void* x, const void* wt, const void* bias, void* out, int B,
                              int C, int D, int H, int W, long long sb, long long sc,
                              long long sd, long long sh, int K, int pd, int ph, int pw,
                              int c_bf16, int* launched, void* stream) {
  Shape s{C, D, H, W, D + 2 * pd - K + 1, H + 2 * ph - K + 1, W + 2 * pw - K + 1, pd, ph, pw,
          sb, sc, sd, sh};
  if (B < 1 || C < 1 || s.Do < 1 || s.Ho < 1 || s.Wo < 1 || pd < 0 || ph < 0 || pw < 0 ||
      (long long)(s.Do + kTileD - 1) / kTileD * B > 65535 || (s.Ho + kTileH - 1) / kTileH > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c_bf16) return launch_k<__nv_bfloat16>(x, wt, bias, out, s, B, K, launched, st);
  return launch_k<float>(x, wt, bias, out, s, B, K, launched, st);
}
