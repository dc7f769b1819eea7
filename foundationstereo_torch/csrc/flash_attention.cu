// Forward flash attention over the ViT patch tokens (no mask except the
// ragged end of the token axis).
//
// Replaces the TPU kernel foundationstereo_tpu/models/dinov2.py:
// flash_vit_attention, which calls the library's Pallas TPU flash attention
// (jax.experimental.pallas.ops.tpu.flash_attention) on N padded to 512 and
// masks the padding with segment ids; and, for one shard of the
// multi-device path, flash_vit_attention_sharded (dinov2.py:106), which runs
// that kernel on a (batch, heads) shard.
//
//   out[b, n, h, :] = softmax_m(scale * q[b, n, h, :] . k[b, m, h, :]) @ v[b, m, h, :]
//
// q, k and v are read from the packed qkv projection (B, N, 3, HT, 64) as
// the ViT produces it; the launch covers the H heads [h0, h0 + H) (all of
// them on one device; a head shard reads its slice in place, no copy) and
// writes out (B, N, H, 64) in qkv's type, bf16 or fp32, with fp32 softmax
// statistics and accumulators. A (b, h) pair is the same arithmetic whatever
// the head range, so head shards stitch to the single launch bit for bit.
//
// Bound on the H100: operations (4*N^2*64 FLOP per (b, h); at N = 5377 the
// arithmetic intensity is ~N/2 FLOP per byte, far above the card's ~295).
//
// bf16 (the main path): a simple FlashAttention-2 forward with mma.sync
// m16n8k16 bf16 tiles: one block of 4 warps owns 64 query rows, each warp 16
// rows whose Q fragments stay in registers; K and V tiles of 64 keys go
// through shared memory; the online softmax rescales the accumulator
// fragments in registers, so no N x N tensor is ever stored. Keys past N are
// masked to -inf and loaded as zeros, queries past N compute on zeros and are
// not stored, so ragged N needs no padding copy. Later versions can move to
// wgmma/TMA with a pipelined K/V ring.
//
// fp32 (the model without mixed precision): the same online softmax on the
// fp32 FMA units, with no rounding of q, k, v or the probabilities: one
// thread per query row holds q and its accumulator in registers; K and V
// tiles of 32 keys go through shared memory, where every thread of a warp
// reads the same key (a broadcast).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHd = 64;          // head dim
constexpr int kBq = 64;          // query rows per block (4 warps x 16)
constexpr int kBk = 64;          // keys per tile
constexpr int kLds = kHd + 8;    // shared row stride in bf16 (144 bytes)
constexpr int kThreads = 128;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_pair(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ out,
                 int N, int H, int HT, int h0, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 ks[kBk * kLds];
  __shared__ __align__(16) __nv_bfloat16 vs[kBk * kLds];

  const int b = blockIdx.y / H, h = blockIdx.y % H;  // h: the output head
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / thread in group
  const size_t tok = (size_t)3 * HT * kHd;  // token stride in qkv
  const __nv_bfloat16* qb = qkv + (size_t)b * N * tok + (size_t)(h0 + h) * kHd;
  const __nv_bfloat16* kb = qb + (size_t)HT * kHd;
  const __nv_bfloat16* vb = qb + (size_t)2 * HT * kHd;

  const int r0 = blockIdx.x * kBq + warp * 16 + g;  // this thread's two rows
  const int r1 = r0 + 8;

  uint32_t qa[kHd / 16][4];
#pragma unroll
  for (int kc = 0; kc < kHd / 16; ++kc) {
    const int col = kc * 16 + t * 2;
    qa[kc][0] = r0 < N ? ld32(qb + r0 * tok + col) : 0u;
    qa[kc][1] = r1 < N ? ld32(qb + r1 * tok + col) : 0u;
    qa[kc][2] = r0 < N ? ld32(qb + r0 * tok + col + 8) : 0u;
    qa[kc][3] = r1 < N ? ld32(qb + r1 * tok + col + 8) : 0u;
  }

  float o[kHd / 8][4];
#pragma unroll
  for (int i = 0; i < kHd / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int k0 = 0; k0 < N; k0 += kBk) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = threadIdx.x; idx < kBk * kHd / 8; idx += kThreads) {
      const int row = idx / (kHd / 8), c8 = (idx % (kHd / 8)) * 8;
      const int key = k0 + row;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
      if (key < N) {
        kv = *reinterpret_cast<const uint4*>(kb + key * tok + c8);
        vv = *reinterpret_cast<const uint4*>(vb + key * tok + c8);
      }
      *reinterpret_cast<uint4*>(&ks[row * kLds + c8]) = kv;
      *reinterpret_cast<uint4*>(&vs[row * kLds + c8]) = vv;
    }
    __syncthreads();

    // S = Q K^T for 64 keys: 8 n-tiles of 8 keys.
    float s[kBk / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBk / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* krow = &ks[(nt * 8 + g) * kLds + t * 2];
#pragma unroll
      for (int kc = 0; kc < kHd / 16; ++kc)
        mma_bf16(s[nt], qa[kc], ld32(krow + kc * 16), ld32(krow + kc * 16 + 8));
    }

    // Online softmax in the log2 domain; keys past N are masked out.
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kBk / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool valid = k0 + nt * 8 + t * 2 + j < N;
        s[nt][j] = valid ? s[nt][j] * scale_log2 : -INFINITY;
        s[nt][2 + j] = valid ? s[nt][2 + j] * scale_log2 : -INFINITY;
        mx0 = fmaxf(mx0, s[nt][j]);
        mx1 = fmaxf(mx1, s[nt][2 + j]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // Key k0 < N is valid, so the new maxima are finite.
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBk / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[nt][j] = exp2f(s[nt][j] - mn0);
        s[nt][2 + j] = exp2f(s[nt][2 + j] - mn1);
        ls0 += s[nt][j];
        ls1 += s[nt][2 + j];
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      ls0 += __shfl_xor_sync(0xffffffffu, ls0, off);
      ls1 += __shfl_xor_sync(0xffffffffu, ls1, off);
    }
    l0 = l0 * a0 + ls0;
    l1 = l1 * a1 + ls1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int nt = 0; nt < kHd / 8; ++nt) {
      o[nt][0] *= a0;
      o[nt][1] *= a0;
      o[nt][2] *= a1;
      o[nt][3] *= a1;
    }

    // O += P V: P's accumulator fragments become A fragments directly.
#pragma unroll
    for (int kc = 0; kc < kBk / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      const __nv_bfloat16* v0 = &vs[(kc * 16 + t * 2) * kLds + g];
#pragma unroll
      for (int nt = 0; nt < kHd / 8; ++nt) {
        const __nv_bfloat16* vp = v0 + nt * 8;
        const uint32_t b0 = pack_pair(vp[0], vp[kLds]);
        const uint32_t b1 = pack_pair(vp[8 * kLds], vp[9 * kLds]);
        mma_bf16(o[nt], pa, b0, b1);
      }
    }
  }

  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int nt = 0; nt < kHd / 8; ++nt) {
    const int col = nt * 8 + t * 2;
    if (r0 < N)
      *reinterpret_cast<uint32_t*>(out + ((size_t)(b * N + r0) * H + h) * kHd + col) =
          pack_bf16(o[nt][0] * inv0, o[nt][1] * inv0);
    if (r1 < N)
      *reinterpret_cast<uint32_t*>(out + ((size_t)(b * N + r1) * H + h) * kHd + col) =
          pack_bf16(o[nt][2] * inv1, o[nt][3] * inv1);
  }
}

constexpr int kBq32 = 128;  // query rows per block of the fp32 kernel (1 per thread)
constexpr int kBk32 = 32;   // keys per tile of the fp32 kernel

__global__ void __launch_bounds__(kBq32)
flash_fwd_f32_kernel(const float* __restrict__ qkv, float* __restrict__ out, int N, int H,
                     int HT, int h0, float scale_log2) {
  __shared__ __align__(16) float ks[kBk32 * kHd];
  __shared__ __align__(16) float vs[kBk32 * kHd];

  const int b = blockIdx.y / H, h = blockIdx.y % H;  // h: the output head
  const size_t tok = (size_t)3 * HT * kHd;
  const float* qb = qkv + (size_t)b * N * tok + (size_t)(h0 + h) * kHd;
  const float* kb = qb + (size_t)HT * kHd;
  const float* vb = qb + (size_t)2 * HT * kHd;
  const int row = blockIdx.x * kBq32 + threadIdx.x;

  float q[kHd], o[kHd];
#pragma unroll
  for (int d = 0; d < kHd; d += 4) {
    const float4 v4 = row < N ? *reinterpret_cast<const float4*>(qb + row * tok + d)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    q[d] = v4.x, q[d + 1] = v4.y, q[d + 2] = v4.z, q[d + 3] = v4.w;
    o[d] = o[d + 1] = o[d + 2] = o[d + 3] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < N; k0 += kBk32) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = threadIdx.x; idx < kBk32 * kHd / 4; idx += kBq32) {
      const int r = idx / (kHd / 4), c4 = (idx % (kHd / 4)) * 4;
      const int key = k0 + r;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (key < N) {
        kv = *reinterpret_cast<const float4*>(kb + key * tok + c4);
        vv = *reinterpret_cast<const float4*>(vb + key * tok + c4);
      }
      *reinterpret_cast<float4*>(&ks[r * kHd + c4]) = kv;
      *reinterpret_cast<float4*>(&vs[r * kHd + c4]) = vv;
    }
    __syncthreads();

    float s[kBk32];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBk32; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < kHd; d += 4) {
        const float4 k4 = *reinterpret_cast<const float4*>(&ks[j * kHd + d]);
        dot = fmaf(q[d], k4.x, dot);
        dot = fmaf(q[d + 1], k4.y, dot);
        dot = fmaf(q[d + 2], k4.z, dot);
        dot = fmaf(q[d + 3], k4.w, dot);
      }
      s[j] = k0 + j < N ? dot * scale_log2 : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    // Key k0 < N is valid, so the new maximum is finite.
    const float mn = fmaxf(m, mx), alpha = exp2f(m - mn);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < kHd; ++d) o[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kBk32; ++j) {
      const float p = exp2f(s[j] - mn);
      l += p;
#pragma unroll
      for (int d = 0; d < kHd; d += 4) {
        const float4 v4 = *reinterpret_cast<const float4*>(&vs[j * kHd + d]);
        o[d] = fmaf(p, v4.x, o[d]);
        o[d + 1] = fmaf(p, v4.y, o[d + 1]);
        o[d + 2] = fmaf(p, v4.z, o[d + 2]);
        o[d + 3] = fmaf(p, v4.w, o[d + 3]);
      }
    }
    m = mn;
  }

  if (row < N) {
    const float inv = 1.f / l;
    float* orow = out + ((size_t)(b * N + row) * H + h) * kHd;
#pragma unroll
    for (int d = 0; d < kHd; d += 4)
      *reinterpret_cast<float4*>(orow + d) =
          make_float4(o[d] * inv, o[d + 1] * inv, o[d + 2] * inv, o[d + 3] * inv);
  }
}

}  // namespace

// qkv (B, N, 3, HT, 64) contiguous, bf16 when is_bf16 else fp32 -> out
// (B, N, H, 64) of the same type for the heads [h0, h0 + H); scale is the
// softmax scale applied to q.k. Returns cudaGetLastError() after the launch.
extern "C" int fs_flash_attention(const void* qkv, void* out, int B, int N, int H, int HT,
                                  int h0, float scale, int is_bf16, void* stream) {
  if (H < 1 || h0 < 0 || h0 + H > HT) return (int)cudaErrorInvalidValue;
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    dim3 grid((N + kBq - 1) / kBq, B * H);
    flash_fwd_kernel<<<grid, kThreads, 0, st>>>(static_cast<const __nv_bfloat16*>(qkv),
                                                 static_cast<__nv_bfloat16*>(out), N, H, HT, h0,
                                                 scale_log2);
  } else {
    dim3 grid((N + kBq32 - 1) / kBq32, B * H);
    flash_fwd_f32_kernel<<<grid, kBq32, 0, st>>>(static_cast<const float*>(qkv),
                                                  static_cast<float*>(out), N, H, HT, h0,
                                                  scale_log2);
  }
  return (int)cudaGetLastError();
}
