// Three-pass TF32 ("3xTF32") products on Hopper's tensor cores, shared by the
// fp32 variants of the 3x3 conv (conv3x3.cu) and the ViT flash attention
// (flash_attention.cu).
//
// An fp32 value x is split into x = hi + lo + r with hi = tf32(x) and lo =
// tf32(x - hi), both rounded to nearest (cvt.rna): |r| <= 2^-22 |x|. A product
// a * b is taken as lo_a * hi_b + hi_a * lo_b + hi_a * hi_b (lo_a * lo_b,
// ~2^-22 of it, is dropped); each tf32 x tf32 product is exact in fp32, so the
// three passes keep ~22 of fp32's 24 bits where one pass keeps ~11. The
// passes run small terms first, so that they enter the accumulator while it
// is small.
//
// The tensor cores add into the accumulator rounding toward zero, which
// biases a long sum (a model of it at K = 4608, the 512-channel conv, puts
// the mean error at ~4x the conv's fp32 limit). So each kernel sums a short
// run of K into a fresh accumulator and adds that partial sum to its fp32
// total with an ordinary (round-to-nearest) FADD or FFMA: the conv once per
// 16-channel chunk, the attention once per key tile.
//
// wgmma with TF32 operands takes no transpose flag: A and B in shared memory
// are both K-major. Every operand here uses the layout without swizzle: core
// matrices of 8 rows x 16 bytes (4 tf32 of K), `lbo` bytes apart along K and
// `sbo` bytes apart along M or N. A K step (8) is two core matrices.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

// x -> (hi, lo), both tf32 bit patterns (low 13 mantissa bits zero).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));   // x - hi is exact in fp32
}

// The four values of v -> hi (returned) and lo, as 16-byte vectors.
__device__ __forceinline__ uint4 split4(const float4& v, uint4& lo) {
  uint4 hi;
  split(v.x, hi.x, lo.x);
  split(v.y, hi.y, lo.y);
  split(v.z, hi.z, lo.z);
  split(v.w, hi.w, lo.w);
  return hi;
}

// Rotates four 16-byte vectors left by rot (0-3) with static register
// indices: the producers store vector i at slot (i + rot) & 3 so that a
// quarter-warp's 16-byte stores hit 8 bank groups.
__device__ __forceinline__ void rotate4(uint4 (&v)[4], int rot) {
  if (rot & 1) {
    const uint4 t = v[0];
    v[0] = v[1], v[1] = v[2], v[2] = v[3], v[3] = t;
  }
  if (rot & 2) {
    uint4 t = v[0];
    v[0] = v[2], v[2] = t;
    t = v[1], v[1] = v[3], v[3] = t;
  }
}

// The shared-memory matrix descriptor of a K-major operand without swizzle.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

#define TF32X3_ACC8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                       "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x 128] (+)= A[64 x 8] * B[8 x 128], A and B tf32 in shared memory;
// d is overwritten where acc == 0. Thread t of the warpgroup holds rows
// 16 (t / 32) + (t % 32) / 4 + 8 i and columns 8 j + 2 (t % 4) + k in
// d[4 j + 2 i + k].
__device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : TF32X3_ACC8(0), TF32X3_ACC8(8), TF32X3_ACC8(16), TF32X3_ACC8(24), TF32X3_ACC8(32),
        TF32X3_ACC8(40), TF32X3_ACC8(48), TF32X3_ACC8(56)
      : "l"(da), "l"(db), "r"(acc));
}

// d[64 x 64] (+)= A[64 x 8] * B[8 x 64], A and B tf32 in shared memory.
__device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : TF32X3_ACC8(0), TF32X3_ACC8(8), TF32X3_ACC8(16), TF32X3_ACC8(24)
      : "l"(da), "l"(db), "r"(acc));
}

// d[64 x 64] (+)= A[64 x 8] * B[8 x 64], A tf32 in registers, B tf32 in
// shared memory. Each warp gives its 16 rows of A as the m16n8k8 TF32
// fragment: a0 (row g, column c), a1 (row g + 8, column c), a2 (row g,
// column c + 4), a3 (row g + 8, column c + 4), g = lane / 4, c = lane % 4.
__device__ __forceinline__ void mma(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                    uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : TF32X3_ACC8(0), TF32X3_ACC8(8), TF32X3_ACC8(16), TF32X3_ACC8(24)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(acc));
}

#undef TF32X3_ACC8

}  // namespace tf32x3
