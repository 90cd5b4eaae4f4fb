// One warp scores one fp32 row against a query row held in shared memory.
// Shared by gather_distance.cu and beam_search.cu, so the two kernels sum
// every (query, row) distance in the same order.
#pragma once
#include <cuda_runtime.h>

// Returns 1 - <q, x> (l2 = 0: cosine, ip) or |q - x|^2 (l2 = 1) to every
// lane of the calling warp; all 32 lanes must call it together. With
// vec4 = 1 (D % 4 == 0, x and q_s 16-byte aligned) each lane reads 16-byte
// float4s: the same 128-byte-coalesced traffic in a quarter of the load
// instructions, so more of a row's bytes are in flight at once.
__device__ __forceinline__ float warp_row_distance(
    const float* __restrict__ x, const float* q_s, int D, int lane, int l2,
    int vec4) {
  float acc = 0.f;
  if (vec4) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* q4 = reinterpret_cast<const float4*>(q_s);
    for (int i = lane; i < (D >> 2); i += 32) {
      const float4 a = __ldg(x4 + i);
      const float4 b = q4[i];
      if (l2) {
        const float d0 = a.x - b.x, d1 = a.y - b.y, d2 = a.z - b.z,
                    d3 = a.w - b.w;
        acc = fmaf(d0, d0, acc);
        acc = fmaf(d1, d1, acc);
        acc = fmaf(d2, d2, acc);
        acc = fmaf(d3, d3, acc);
      } else {
        acc = fmaf(b.x, a.x, acc);
        acc = fmaf(b.y, a.y, acc);
        acc = fmaf(b.z, a.z, acc);
        acc = fmaf(b.w, a.w, acc);
      }
    }
  } else if (l2) {
    for (int d = lane; d < D; d += 32) {
      const float diff = __ldg(x + d) - q_s[d];
      acc = fmaf(diff, diff, acc);
    }
  } else {
    for (int d = lane; d < D; d += 32) acc = fmaf(q_s[d], __ldg(x + d), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  return l2 ? acc : 1.f - acc;
}
