// Device helpers shared by every kernel of rt_tpu_torch/csrc.
//
// Bit-level contract (with rt_tpu_torch/ops/render.py and the JAX package):
//   * hash_u01 is pallas_render `_hash_u01`, the counter-based generator of
//     rng_impl="hash", in wrapping 32-bit arithmetic;
//   * rsqrt is written 1/sqrtf(x): CUDA's rsqrtf is not correctly rounded.
//     The libraries are built with --fmad=false (rt_tpu_torch/ops/_build.py),
//     so no a*b+c is contracted into an FMA and every operation rounds once,
//     in the order the plain PyTorch versions evaluate it.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kBig = 3.0e38f;
constexpr float kMinHit = 0.001f;
constexpr int kThreads = 128;

// The winner word of one bounce (pallas_blockwise._bounce_once
// want_record): the winner's table row, bit 24 for a plane, bit 26 for a
// box, or bit 25 alone on a miss.  The forward kernels write it
// (trace.cuh); the wavefront gradient and the blockwise gradient kernel
// read it (bounce.cuh replay_winner).
constexpr int32_t kWordRow = (1 << 24) - 1;
constexpr int32_t kWordPlane = 1 << 24;
constexpr int32_t kWordMiss = 1 << 25;
constexpr int32_t kWordBox = 1 << 26;

__device__ __forceinline__ float hash_u01(uint32_t pix, uint32_t seed, uint32_t ctr) {
  uint32_t u = pix * 0x9E3779B9u + seed * 97929u + (ctr * 30103u + 1u);
  u ^= u >> 16;
  u *= 0x7FEB352Du;
  u ^= u >> 15;
  u *= 0x846CA68Bu;
  u ^= u >> 16;
  return static_cast<float>(u >> 8) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ float rsqrt_rn(float x) { return 1.0f / sqrtf(x); }

}  // namespace
