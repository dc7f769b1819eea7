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
// the head range or the query tile, so head shards stitch to the single
// launch bit for bit.
//
// What bounds it on the H100: operations, of two kinds. The products are
// 4*N^2*64 FLOP per (b, h) (at the main path's B = 2, 16 heads, N = 5377:
// 2.37e11 FLOP, 0.239 ms at 989 TF/s; the arithmetic intensity, ~N/2 FLOP
// per byte, is far above the card's ~295). At head dim 64 the softmax's
// exponentials cost almost as much: one ex2 per score, N^2 per (b, h), on
// the SFU's 16 per SM per clock (9.25e8 scores, ~0.22 ms at 1.98 GHz). The
// kernel comes near its bound only if the softmax runs under the products.
// On an H100 SXM (700 W) this design runs the main shape in 0.50-0.51 ms
// (2.1x the products' bound).
//
// bf16 (the main path): wgmma fed by a TMA K/V ring, warp-specialised.
// - A block owns kBq = 192 query rows of one (b, h), 64 for each of 3
//   consumer warpgroups, plus one producer warpgroup whose single thread
//   issues every load (on the H100, 3 consumers outran 2 at both the K3
//   and the K3s shard shapes: 0.51 against 0.59 ms at K3). The grid
//   is 1-D and puts each pair's last, ragged query tile at its end (at N =
//   5377 and 192 rows that tile holds 1 row); a consumer warpgroup with no
//   row below N exits at once, so those tail blocks are short.
// - Loads are TMA boxes of 64 tokens x 64 dims from qkv in place, through
//   one 3-D tensor map over (3*HT*64, N, B) with the 128-byte swizzle: the
//   column coordinate picks q, k or v and the head. Rows past N arrive as
//   zeros (the map's out-of-bounds fill), so ragged N needs no padding copy;
//   keys past N are also masked to -inf. Q is loaded once; K and V tiles of
//   128 keys go through a ring of kStages stages on full (one per K and per
//   V) and empty mbarriers.
// - S = Q K^T is wgmma m64n128k16 x 4 from shared memory (both operands
//   K-major, 128-byte swizzle). O += P V is wgmma m64n64k16 x 8 with P from
//   registers: the fp32 accumulator layout of a 16-key chunk is the register
//   A layout, so P is converted in place; V is B read MN-major from its
//   [key][dim] tile (the transpose flag), no copy.
// - The softmax is hidden under the products in two ways. Within a
//   warpgroup, tile j's Q K^T and tile j-1's P V are issued together and the
//   softmax of S_j runs while P_{j-1} V_{j-1} is on the tensor cores. Across
//   warpgroups, named barriers pass a token round-robin so that one
//   warpgroup issues its products while the others run their softmax.
// - The softmax runs in the log2 domain: ex2.approx of one FFMA per score,
//   s * scale * log2(e) - max, on the unscaled scores (scale > 0); row
//   maxima are reduced over the 4 threads of an accumulator row; row sums
//   stay per thread until the end.
// - Epilogue: 1/l, one rounding to bf16, staged swizzled through the
//   warpgroup's Q buffer and stored as whole 16-byte pieces of 128-byte rows;
//   rows past N are not stored.
//
// fp32 (the model without mixed precision): the same warp-specialised plan
// on TF32 wgmma in three passes (tf32x3.cuh), held to the fp32 tolerance.
// Bound on the H100: 3 * 2.37e11 FLOP at the main shape, 1.44 ms at 494.7
// TF/s. What changes for 4-byte elements:
// - Every product operand is split into tf32 hi and lo and is K-major (TF32
//   takes no transpose flag), so the producer warpgroup's 128 threads, not
//   TMA, fill the ring: they load each 64-key tile of K and V from qkv in
//   place, split it, and write K as [dim quad][key][4] and V transposed as
//   [key quad][dim][4] (a tile's four images are 64 KB; 3 stages). Keys past
//   N are written as zeros and masked.
// - 2 consumer warpgroups of 64 query rows (128 per block): Q's hi stays in
//   registers as the A fragments, its lo in shared memory. S = Q K^T is
//   three passes of wgmma m64n64k8 (Q lo K hi, Q hi K lo, Q hi K hi).
// - P is split in registers; its accumulator gives each 8-key group's keys
//   to the A fragment in the order 0, 2, 4, 6, 1, 3, 5, 7, and V^T stores
//   them in that order. A tile's P V (P lo V hi, P hi V lo, P hi V hi) goes
//   into a fresh accumulator that one FFMA adds to the rescaled O (the
//   tensor cores round toward zero; a sum over all N keys would drift).
// - The softmax runs in the log2 domain on the scaled scores (any scale);
//   the two consumer warpgroups overlap one's softmax with the other's
//   products. Outputs are stored as fp32 pairs from the accumulators.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int kHd = 64;                       // head dim
constexpr int kBk = 128;                      // keys per K/V tile
constexpr int kStages = 5;                    // K/V ring stages
constexpr int kBox = 64;                      // tokens per TMA box
constexpr int kBoxBytes = kBox * kHd * 2;     // 8 KB: one box, 64 rows of 128 bytes
constexpr int kTileBytes = kBk * kHd * 2;     // 16 KB: one K or V tile

constexpr int kConsumers = 3;                 // consumer warpgroups, 64 query rows each
constexpr int kBq = 64 * kConsumers;          // query rows per block
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kRing = kConsumers * kBoxBytes;                  // Q: one box per consumer
constexpr int kBars = kRing + kStages * 2 * kTileBytes;
constexpr int kSmem = kBars + 8 * (1 + 3 * kStages) + 1024;    // + alignment slack
// setmaxnreg: the producer's registers go to the consumers.
constexpr int kProducerRegs = 32;
constexpr int kConsumerRegs = 160;
static_assert(kSmem <= 232448, "shared memory");

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

// One TMA box (64 dims x 64 tokens of one image) global -> shared, completing
// its bytes on the mbarrier; coordinates (column, token, image).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int col, int row, int img,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(img), "r"(bar)
      : "memory");
}

// Shared-memory matrix descriptors, 128-byte swizzle (rows of 128 bytes,
// 8-row groups 1024 bytes apart). K-major: the 16-element K step moves the
// start by 32 bytes. MN-major (V as B of P V): a 16-key step is two 8-key
// groups (SBO = 1024); N = 64 is one swizzle atom, so LBO is unused.
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

// Keeps the compiler from moving register reads or writes across the
// asynchronous wgmma's issue and wait (and from reusing the registers of an
// in-flight A operand).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define ACC8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x 128] (+)= A[64 x 16] * B[16 x 128], A and B bf16 K-major in shared
// memory; d is overwritten where acc == 0. Thread t of the warpgroup holds
// rows 16 (t / 32) + (t % 32) / 4 + 8 i and columns 8 j + 2 (t % 4) + k in
// d[4 j + 2 i + k].
__device__ __forceinline__ void wgmma_s(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56)
      : "l"(da), "l"(db), "r"(acc));
}

// d[64 x 64] += A[64 x 16] * B[16 x 64], A bf16 in registers (the
// m16n8k16 A fragment of each warp's 16 rows), B bf16 MN-major in shared
// memory (transposed).
__device__ __forceinline__ void wgmma_o(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

#undef ACC8

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

// The round-robin token over the block's active consumer warpgroups:
// warpgroup w issues its products between turn_take (named barrier 1 + w)
// and turn_pass (the next warpgroup's barrier). Each barrier counts the
// taker's 128 threads and the passer's 128.
__device__ __forceinline__ void turn_take(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg, int active) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + (wg + 1) % active) : "memory");
}

struct Ring {
  uint32_t q;        // this warpgroup's Q box
  uint32_t ring;     // K/V stage s: K at ring + 2 s kTileBytes, V kTileBytes after
  uint32_t kfull, vfull, empty;
};

// One step of a consumer warpgroup: tile j's S = Q K_j^T (HK) and tile
// j - 1's O += P V_{j-1} (HV), issued together in the warpgroup's turn; then
// the online softmax of S_j under P V, and the rescale of O once P V is done.
template <bool HK, bool HV>
__device__ __forceinline__ void step(int j, int wg, int active, bool last_turn, const Ring& r, int N,
                                     float scale_log2, int t, int lane, float (&s)[64],
                                     float (&o)[32], uint32_t (&p)[32], float (&m)[2],
                                     float (&l)[2]) {
  const int sk = j % kStages, sv = (j + kStages - 1) % kStages;
  if (HK) mbar_wait(r.kfull + 8 * sk, (j / kStages) & 1);
  if (HV) mbar_wait(r.vfull + 8 * sv, ((j - 1) / kStages) & 1);
  if (active > 1) turn_take(wg);
  wgmma_fence();
  if (HK) {
    const uint32_t kb = r.ring + sk * 2 * kTileBytes;
#pragma unroll
    for (int kk = 0; kk < kHd / 16; ++kk) wgmma_s(s, desc_sw128(r.q + kk * 32), desc_sw128(kb + kk * 32), kk);
    wgmma_commit();
  }
  if (HV) {
    const uint32_t vb = r.ring + sv * 2 * kTileBytes + kTileBytes;
#pragma unroll
    for (int kc = 0; kc < kBk / 16; ++kc)
      wgmma_o(o, p[4 * kc], p[4 * kc + 1], p[4 * kc + 2], p[4 * kc + 3], desc_sw128(vb + kc * 2048));
    wgmma_commit();
  }
  if (active > 1 && !last_turn) turn_pass(wg, active);

  float alpha[2] = {1.f, 1.f};
  if (HK) {
    if (HV)
      wgmma_wait<1>();   // S_j is done; P V may still run
    else
      wgmma_wait<0>();
    fence_regs(s);
    // Keys past N (the last tile only) to -inf. The scores stay unscaled:
    // the scale (> 0) is folded into the exponent's FFMA.
    const int key0 = j * kBk;
    if (key0 + kBk > N) {
#pragma unroll
      for (int jj = 0; jj < kBk / 8; ++jj)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (key0 + 8 * jj + 2 * t + (i & 1) >= N) s[4 * jj + i] = -INFINITY;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {     // rows g and g + 8 of the warp
      float mx = m[i];
#pragma unroll
      for (int jj = 0; jj < kBk / 8; ++jj) mx = fmaxf(mx, fmaxf(s[4 * jj + 2 * i], s[4 * jj + 2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // Key 0 of tile 0 is valid, so mx is finite; m starts at -inf.
      alpha[i] = ex2((m[i] - mx) * scale_log2);
      m[i] = mx;
      const float base = mx * scale_log2;
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < kBk / 8; ++jj)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const float e = ex2(fmaf(s[4 * jj + 2 * i + k], scale_log2, -base));
          s[4 * jj + 2 * i + k] = e;
          sum += e;
        }
      l[i] = l[i] * alpha[i] + sum;   // this thread's part of the row sum
    }
  }
  if (HV) {
    wgmma_wait<0>();     // P_{j-1} V_{j-1} is done: release the stage
    fence_regs(o);
    fence_regs(p);
    if (lane == 0) mbar_arrive(r.empty + 8 * sv);
  }
  if (HK) {
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
    // The accumulator of keys 16 kc .. 16 kc + 15 is the A fragment of P.
#pragma unroll
    for (int i = 0; i < 32; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(__grid_constant__ const CUtensorMap map, __nv_bfloat16* __restrict__ out, int N,
                 int H, int HT, int h0, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  // [Q boxes][K/V ring][mbarriers], from a 1024-byte boundary (the swizzle's).
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t qfull = base + kBars;
  Ring r;
  r.ring = base + kRing;
  r.kfull = qfull + 8;
  r.vfull = r.kfull + 8 * kStages;
  r.empty = r.vfull + 8 * kStages;

  // Block L of the 1-D grid: query tile L % (T - 1) of pair L / (T - 1) for
  // the first pairs x (T - 1) blocks, then the last (ragged) query tile of
  // each pair, so the short tail tiles run at the end of the grid.
  const int T = (N + kBq - 1) / kBq, pairs = gridDim.x / T;
  const int L = blockIdx.x, full = pairs * (T - 1);
  const int bh = L < full ? L / (T - 1) : L - full, qt = L < full ? L % (T - 1) : T - 1;
  const int b = bh / H, h = bh % H;   // h: the output head
  const int q0 = qt * kBq;
  // Consumer warpgroups with a query row below N; the others exit at once.
  const int active = min(kConsumers, (N - q0 + 63) / 64);
  const int nT = (N + kBk - 1) / kBk;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(r.kfull + 8 * s, 1);
      mbar_init(r.vfull + 8 * s, 1);
      mbar_init(r.empty + 8 * s, 4 * active);     // one arrival per active consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    if (threadIdx.x == 128 * kConsumers) {
      const int qc = (h0 + h) * kHd, kc = (HT + h0 + h) * kHd, vc = (2 * HT + h0 + h) * kHd;
      mbar_expect_tx(qfull, active * kBoxBytes);
      for (int w = 0; w < active; ++w) tma_load(base + w * kBoxBytes, &map, qc, q0 + 64 * w, b, qfull);
      for (int j = 0; j < nT; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(r.empty + 8 * s, (j / kStages - 1) & 1);
        const uint32_t kb = r.ring + s * 2 * kTileBytes;
        mbar_expect_tx(r.kfull + 8 * s, kTileBytes);
        tma_load(kb, &map, kc, j * kBk, b, r.kfull + 8 * s);
        tma_load(kb + kBoxBytes, &map, kc, j * kBk + kBox, b, r.kfull + 8 * s);
        mbar_expect_tx(r.vfull + 8 * s, kTileBytes);
        tma_load(kb + kTileBytes, &map, vc, j * kBk, b, r.vfull + 8 * s);
        tma_load(kb + kTileBytes + kBoxBytes, &map, vc, j * kBk + kBox, b, r.vfull + 8 * s);
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
  if (wg >= active) return;
  const int lane = threadIdx.x & 31, w4 = (threadIdx.x >> 5) & 3, t = lane & 3, g = lane >> 2;
  r.q = base + wg * kBoxBytes;
  float s[64], o[32], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  uint32_t p[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
  // The last active warpgroup hands the first turn to warpgroup 0.
  if (active > 1 && wg == active - 1) turn_pass(wg, active);
  mbar_wait(qfull, 0);

  // nT + 1 turns: S_0; (S_j, P_{j-1} V_{j-1}) for j = 1 .. nT - 1; P V of the last tile.
  step<true, false>(0, wg, active, false, r, N, scale_log2, t, lane, s, o, p, m, l);
  for (int j = 1; j < nT; ++j)
    step<true, true>(j, wg, active, false, r, N, scale_log2, t, lane, s, o, p, m, l);
  step<false, true>(nT, wg, active, wg == active - 1, r, N, scale_log2, t, lane, s, o, p, m, l);

  // Epilogue: the full row sums, 1/l, one rounding; staged in this
  // warpgroup's Q box (its last reader, the last S wgmma, is done) with the
  // 128-byte swizzle (16-byte piece c of row n at c ^ (n % 8): conflict-free
  // both ways), then stored as 16-byte pieces, 8 threads per 128-byte row.
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float sum = l[i];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    inv[i] = 1.f / sum;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  unsigned char* st = smem + wg * kBoxBytes;
#pragma unroll
  for (int jj = 0; jj < kHd / 8; ++jj)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = 16 * w4 + g + 8 * i;     // row % 8 == g
      *reinterpret_cast<uint32_t*>(st + row * 128 + ((jj ^ g) << 4) + 4 * t) =
          pack_bf16(o[4 * jj + 2 * i] * inv[i], o[4 * jj + 2 * i + 1] * inv[i]);
    }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + kConsumers + wg) : "memory");
  const int tid = threadIdx.x & 127, qw = q0 + 64 * wg;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int item = tid + 128 * u, row = item >> 3, c = item & 7;
    if (qw + row < N)
      *reinterpret_cast<uint4*>(out + ((size_t)(b * N + qw + row) * H + h) * kHd + 8 * c) =
          *reinterpret_cast<const uint4*>(st + row * 128 + ((c ^ (row & 7)) << 4));
  }
}

// fp32 kernel: the same plan on TF32 wgmma in three passes (tf32x3.cuh).
constexpr int kConsumers32 = 2;                  // consumer warpgroups, 64 query rows each
constexpr int kBq32 = 64 * kConsumers32;         // query rows per block
constexpr int kBk32 = 64;                        // keys per K/V tile
constexpr int kStages32 = 3;                     // K/V ring stages
constexpr int kThreads32 = 128 * (kConsumers32 + 1);
constexpr int kImage32 = kBk32 * kHd * 4;        // 16 KB: one tile's hi or lo image
constexpr int kQlo32 = kConsumers32 * kImage32;  // Q's lo image per consumer
constexpr int kStage32 = 4 * kImage32;           // K hi, K lo, V^T hi, V^T lo
constexpr int kBars32 = kQlo32 + kStages32 * kStage32;
constexpr int kSmem32 = kBars32 + 8 * 2 * kStages32 + 1024;
// setmaxnreg moves registers within the block's launch allocation: 168 per
// thread at __launch_bounds__(384, 1).
constexpr int kProducerRegs32 = 104;
constexpr int kConsumerRegs32 = 200;
static_assert(kSmem32 <= 232448, "shared memory");
static_assert(kConsumers32 * 128 * kConsumerRegs32 + 128 * kProducerRegs32 <= 168 * kThreads32, "registers");

__global__ void __launch_bounds__(kThreads32, 1)
flash_fwd_f32_kernel(const float* __restrict__ qkv, float* __restrict__ out, int N, int H, int HT, int h0,
                     float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  // [Q lo per consumer][K/V ring][mbarriers]
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t ring = base + kQlo32;
  const uint32_t full = base + kBars32, empty = full + 8 * kStages32;

  // Block L of the 1-D grid, as in the bf16 kernel: the last (ragged) query
  // tile of each pair at the end of the grid.
  const int T = (N + kBq32 - 1) / kBq32, pairs = gridDim.x / T;
  const int L = blockIdx.x, nfull = pairs * (T - 1);
  const int bh = L < nfull ? L / (T - 1) : L - nfull, qt = L < nfull ? L % (T - 1) : T - 1;
  const int b = bh / H, h = bh % H;   // h: the output head
  const int q0 = qt * kBq32;
  const int active = min(kConsumers32, (N - q0 + 63) / 64);
  const int nT = (N + kBk32 - 1) / kBk32;
  const int wg = threadIdx.x >> 7;
  const long long tok = 3LL * HT * kHd;
  const float* qb = qkv + (long long)b * N * tok + (long long)(h0 + h) * kHd;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages32; ++s) {
      mbar_init(full + 8 * s, 128);                // every producer thread
      mbar_init(empty + 8 * s, 4 * active);        // one arrival per active consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers32) {
    // ---- producer warpgroup: loads each K and V tile, splits it and writes
    // K [dim quad][key][4] and V^T [key quad][dim][4], hi and lo ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs32) : "memory");
    const int tid = threadIdx.x & 127;
    const float* kb = qb + (long long)HT * kHd;
    const float* vb = qb + 2LL * HT * kHd;
    // K: items (quad 2u + tid / 64, key tid % 64), u = 0..7. V: items (key
    // quad q = tid / 16 + 8u, dim quad dq = tid % 16), u = 0..1.
    const int kkey = tid & 63, kq = tid >> 6, dq = tid & 15, rot = (dq >> 1) & 3;
    for (int j = 0; j < nT; ++j) {
      const int k0 = j * kBk32, s = j % kStages32;
      float4 kv[8], vv[2][4];
      const bool kin = k0 + kkey < N;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        kv[u] = kin ? __ldg(reinterpret_cast<const float4*>(kb + (k0 + kkey) * tok + 4 * (kq + 2 * u)))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int q = (tid >> 4) + 8 * u;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // Column e of quad q is key 8 (q / 2) + 2 e + q % 2 (see V^T below).
          const int key = k0 + 8 * (q >> 1) + 2 * e + (q & 1);
          vv[u][e] = key < N ? __ldg(reinterpret_cast<const float4*>(vb + key * tok + 4 * dq))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
      if (j >= kStages32) mbar_wait(empty + 8 * s, (j / kStages32 - 1) & 1);
      unsigned char* st = smem + kQlo32 + s * kStage32;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        uint4 lo;
        const uint4 hi = tf32x3::split4(kv[u], lo);
        unsigned char* slot = st + (kq + 2 * u) * 1024 + kkey * 16;
        *reinterpret_cast<uint4*>(slot) = hi;
        *reinterpret_cast<uint4*>(slot + kImage32) = lo;
      }
      // V^T: row d of key quad q holds, in column e, V[key 8 (q / 2) + 2 e +
      // q % 2][d]: each 8-key group in the order 0, 2, 4, 6, 1, 3, 5, 7, the
      // order in which P's accumulator gives its keys to the A fragment. A
      // thread writes the 4 rows of its dim quad, rotated so that a
      // quarter-warp's stores hit 8 bank groups.
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int q = (tid >> 4) + 8 * u;
        uint4 hi[4], lo[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4 col = r == 0 ? make_float4(vv[u][0].x, vv[u][1].x, vv[u][2].x, vv[u][3].x)
                           : r == 1 ? make_float4(vv[u][0].y, vv[u][1].y, vv[u][2].y, vv[u][3].y)
                           : r == 2 ? make_float4(vv[u][0].z, vv[u][1].z, vv[u][2].z, vv[u][3].z)
                                    : make_float4(vv[u][0].w, vv[u][1].w, vv[u][2].w, vv[u][3].w);
          hi[r] = tf32x3::split4(col, lo[r]);
        }
        tf32x3::rotate4(hi, rot);
        tf32x3::rotate4(lo, rot);
        unsigned char* vt = st + 2 * kImage32 + q * 1024;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          unsigned char* slot = vt + (4 * dq + ((r + rot) & 3)) * 16;
          *reinterpret_cast<uint4*>(slot) = hi[r];
          *reinterpret_cast<uint4*>(slot + kImage32) = lo[r];
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(full + 8 * s);
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs32) : "memory");
  if (wg >= active) return;
  const int lane = threadIdx.x & 31, w4 = (threadIdx.x >> 5) & 3, t = lane & 3, g = lane >> 2;
  const int qw = q0 + 64 * wg, row = 16 * w4 + g;   // rows row and row + 8 of the warpgroup
  // Q: hi in registers as the A fragments of the 8 K steps, lo in shared
  // memory [dim quad][row][4].
  uint32_t qh[32];
  const uint32_t qlo = base + wg * kImage32;
  {
    unsigned char* ql = smem + wg * kImage32;
#pragma unroll
    for (int kk = 0; kk < kHd / 8; ++kk)
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = row + 8 * (a & 1), d = 8 * kk + t + 4 * (a >> 1);
        const float v = qw + r < N ? __ldg(qb + (qw + r) * tok + d) : 0.f;
        uint32_t lo;
        tf32x3::split(v, qh[4 * kk + a], lo);
        *reinterpret_cast<uint32_t*>(ql + (d >> 2) * 1024 + r * 16 + (d & 3) * 4) = lo;
      }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  }
  float o[32], ot[32], s[32], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  uint32_t ph[32], pl[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;

  for (int j = 0; j < nT; ++j) {
    const int st = j % kStages32;
    // The first wgmma of S and of P V overwrites its accumulator: new values
    // here end the old ones' lives (else the asm's read keeps them live).
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = ot[i] = 0.f;
    mbar_wait(full + 8 * st, (j / kStages32) & 1);
    const uint32_t khi = ring + st * kStage32, klo = khi + kImage32;
    const uint32_t vhi = khi + 2 * kImage32, vlo = khi + 3 * kImage32;
    // S = Q K^T: Q lo K hi, Q hi K lo, Q hi K hi.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHd / 8; ++kk)
      tf32x3::mma(s, tf32x3::desc(qlo + kk * 2048, 1024, 128), tf32x3::desc(khi + kk * 2048, 1024, 128), kk);
#pragma unroll
    for (int kk = 0; kk < kHd / 8; ++kk)
      tf32x3::mma(s, qh[4 * kk], qh[4 * kk + 1], qh[4 * kk + 2], qh[4 * kk + 3],
                  tf32x3::desc(klo + kk * 2048, 1024, 128), 1);
#pragma unroll
    for (int kk = 0; kk < kHd / 8; ++kk)
      tf32x3::mma(s, qh[4 * kk], qh[4 * kk + 1], qh[4 * kk + 2], qh[4 * kk + 3],
                  tf32x3::desc(khi + kk * 2048, 1024, 128), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(qh);

    // Online softmax in the log2 domain on the scaled scores (any sign of
    // the scale); keys past N (the last tile only) to -inf.
    const int key0 = j * kBk32;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = key0 + 8 * (i >> 2) + 2 * t + (i & 1);
      s[i] = key < N ? s[i] * scale_log2 : -INFINITY;
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {     // rows g and g + 8 of the warp
      float mx = m[i];
#pragma unroll
      for (int jj = 0; jj < kBk32 / 8; ++jj) mx = fmaxf(mx, fmaxf(s[4 * jj + 2 * i], s[4 * jj + 2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // Key 0 of every tile is below N, so mx is finite; m starts at -inf.
      alpha[i] = ex2(m[i] - mx);
      m[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < kBk32 / 8; ++jj)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const float e = ex2(s[4 * jj + 2 * i + k] - mx);
          s[4 * jj + 2 * i + k] = e;
          sum += e;
        }
      l[i] = l[i] * alpha[i] + sum;   // this thread's part of the row sum
    }
    // P's A fragment of K step jj (keys 8 jj .. 8 jj + 7): a0 = (row g, key
    // 2t), a1 = (row g + 8, key 2t), a2 = (row g, key 2t + 1), a3 = (row g +
    // 8, key 2t + 1); the A fragment's column c is key 2c for c < 4 and
    // 2(c - 4) + 1 above, which V^T's key order matches.
#pragma unroll
    for (int jj = 0; jj < kBk32 / 8; ++jj) {
      tf32x3::split(s[4 * jj], ph[4 * jj], pl[4 * jj]);
      tf32x3::split(s[4 * jj + 2], ph[4 * jj + 1], pl[4 * jj + 1]);
      tf32x3::split(s[4 * jj + 1], ph[4 * jj + 2], pl[4 * jj + 2]);
      tf32x3::split(s[4 * jj + 3], ph[4 * jj + 3], pl[4 * jj + 3]);
    }
    // This tile's P V into a fresh accumulator: P lo V hi, P hi V lo, P hi V hi.
    wgmma_fence();
#pragma unroll
    for (int jj = 0; jj < kBk32 / 8; ++jj)
      tf32x3::mma(ot, pl[4 * jj], pl[4 * jj + 1], pl[4 * jj + 2], pl[4 * jj + 3],
                  tf32x3::desc(vhi + jj * 2048, 1024, 128), jj);
#pragma unroll
    for (int jj = 0; jj < kBk32 / 8; ++jj)
      tf32x3::mma(ot, ph[4 * jj], ph[4 * jj + 1], ph[4 * jj + 2], ph[4 * jj + 3],
                  tf32x3::desc(vlo + jj * 2048, 1024, 128), 1);
#pragma unroll
    for (int jj = 0; jj < kBk32 / 8; ++jj)
      tf32x3::mma(ot, ph[4 * jj], ph[4 * jj + 1], ph[4 * jj + 2], ph[4 * jj + 3],
                  tf32x3::desc(vhi + jj * 2048, 1024, 128), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(ot);
    fence_regs(ph);
    fence_regs(pl);
    if (lane == 0) mbar_arrive(empty + 8 * st);
    // The rescaled total plus the tile, rounded to nearest.
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = fmaf(o[i], alpha[(i >> 1) & 1], ot[i]);
  }

  // Epilogue: the full row sums, 1/l, fp32 pairs of columns per thread.
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float sum = l[i];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    inv[i] = 1.f / sum;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = qw + row + 8 * i;
    if (r >= N) continue;
    float* orow = out + ((long long)(b * N + r) * H + h) * kHd + 2 * t;
#pragma unroll
    for (int jj = 0; jj < kHd / 8; ++jj)
      *reinterpret_cast<float2*>(orow + 8 * jj) =
          make_float2(o[4 * jj + 2 * i] * inv[i], o[4 * jj + 2 * i + 1] * inv[i]);
  }
}

// cuTensorMapEncodeTiled from the driver, looked up through the runtime so
// that the library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// launched[0..5] = the grid (x, y, z) and a block's tile (query rows, keys
// per tile, threads) of the launch being made.
void report(int* launched, dim3 grid, int rows, int keys, int threads) {
  const int v[6] = {(int)grid.x, (int)grid.y, (int)grid.z, rows, keys, threads};
  for (int i = 0; i < 6; ++i) launched[i] = v[i];
}

}  // namespace

// qkv (B, N, 3, HT, 64) contiguous and 16-byte aligned, bf16 when is_bf16
// else fp32 -> out (B, N, H, 64) of the same type for the heads [h0, h0 + H);
// scale is the softmax scale applied to q.k (> 0 for bf16).
// launched: 6 ints, set to the grid and block tile of the launch (see
// report). Returns the launch's CUDA error (cudaErrorNotSupported where the
// driver has no cuTensorMapEncodeTiled, cudaErrorInvalidValue where the
// tensor map cannot be encoded).
extern "C" int fs_flash_attention(const void* qkv, void* out, int B, int N, int H, int HT,
                                  int h0, float scale, int is_bf16, int* launched,
                                  void* stream) {
  if (B < 1 || N < 1 || H < 1 || h0 < 0 || h0 + H > HT) return (int)cudaErrorInvalidValue;
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    const cudaError_t attr =
        cudaFuncSetAttribute(flash_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem32);
    if (attr != cudaSuccess) return (int)attr;
    dim3 grid((N + kBq32 - 1) / kBq32 * B * H);
    report(launched, grid, kBq32, kBk32, kThreads32);
    flash_fwd_f32_kernel<<<grid, kThreads32, kSmem32, st>>>(static_cast<const float*>(qkv),
                                                             static_cast<float*>(out), N, H, HT, h0,
                                                             scale_log2);
    return (int)cudaGetLastError();
  }
  if (!(scale > 0.f)) return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  // qkv as a 3-D tensor (columns 3 * HT * 64, tokens N, images B), boxes of
  // 64 columns (one head's q, k or v: 128 bytes, the swizzle's span) by 64
  // tokens; out-of-bounds tokens are filled with zeros.
  const cuuint64_t row = (cuuint64_t)3 * HT * kHd;
  const cuuint64_t dims[3] = {row, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[2] = {row * 2, row * 2 * N};
  const cuuint32_t box[3] = {kHd, kBox, 1}, elem[3] = {1, 1, 1};
  CUtensorMap map;
  const CUresult enc = encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(qkv), dims,
                              strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (enc != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  // The attribute is per device: set it at every launch.
  const cudaError_t attr =
      cudaFuncSetAttribute(flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((N + kBq - 1) / kBq * B * H);
  report(launched, grid, kBq, kBk, kThreads);
  flash_fwd_kernel<<<grid, kThreads, kSmem, st>>>(map, static_cast<__nv_bfloat16*>(out), N, H, HT, h0,
                                                  scale_log2);
  return (int)cudaGetLastError();
}
