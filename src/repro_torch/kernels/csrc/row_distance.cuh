// One warp scores one row against a query row held in shared memory
// (gather_distance.cu). beam_search.cu scores rows staged in shared
// memory with the same lane mapping and summation order (its
// lane_sum_vec / lane_sum_elem and warp_total4), so the two kernels give
// every (query, row) pair the same distance, bit for bit.
//
// Rows are fp32, bf16 or int8 (Row<T> below); an optional per-row scale
// decodes each element as (float)x * scale, the plain version's own
// multiply (ref.gather_distance_ref), before the FMA. The scale is not
// factored out of the dot product: s * sum(q * x) rounds differently
// from sum(q * (x * s)).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Row<T>: kVec elements per 16-byte load; load() reads element d alone,
// load_vec() the i-th 16-byte vector of the row, both decoded to fp32.
template <typename T>
struct Row;

template <>
struct Row<float> {
  static constexpr int kVec = 4;
  __device__ static float load(const float* x, int d) { return __ldg(x + d); }
  __device__ static void load_vec(const float* x, int i, float* v) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(x) + i);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  }
};

template <>
struct Row<__nv_bfloat16> {  // exact widening: the 16 bits become the
  static constexpr int kVec = 8;  // high half of an fp32
  __device__ static float load(const __nv_bfloat16* x, int d) {
    const uint32_t u = __ldg(reinterpret_cast<const unsigned short*>(x) + d);
    return __uint_as_float(u << 16);
  }
  __device__ static void load_vec(const __nv_bfloat16* x, int i, float* v) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(x) + i);
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      v[2 * t] = __uint_as_float(w[t] << 16);
      v[2 * t + 1] = __uint_as_float(w[t] & 0xffff0000u);
    }
  }
};

template <>
struct Row<int8_t> {
  static constexpr int kVec = 16;
  __device__ static float load(const int8_t* x, int d) {
    return static_cast<float>(__ldg(reinterpret_cast<const signed char*>(x) + d));
  }
  __device__ static void load_vec(const int8_t* x, int i, float* v) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(x) + i);
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      v[t] = static_cast<float>(static_cast<int8_t>(w[t >> 2] >> (8 * (t & 3))));
    }
  }
};

// Returns 1 - <q, x> (l2 = 0: cosine, ip) or |q - x|^2 (l2 = 1) to every
// lane of the calling warp; all 32 lanes must call it together. `scale`
// points at the row's decode scale, or is null (fp32, bf16). With vec = 1
// (D * sizeof(T) % 16 == 0, x 16-byte aligned) each lane reads 16-byte
// vectors: the same coalesced traffic in fewer load instructions. Lane
// `lane` sums its elements in row order, then a shuffle tree adds the
// lanes: for fp32 rows the order of the fp32-only version of this
// routine, so its distances are unchanged.
template <typename T>
__device__ __forceinline__ float warp_row_distance(
    const T* __restrict__ x, const float* __restrict__ scale,
    const float* q_s, int D, int lane, int l2, int vec) {
  using R = Row<T>;
  const bool scaled = scale != nullptr;
  const float s = scaled ? __ldg(scale) : 1.f;
  float acc = 0.f;
  if (vec) {
    const float4* q4 = reinterpret_cast<const float4*>(q_s);
    for (int i = lane; i < D / R::kVec; i += 32) {
      float v[R::kVec];
      float qv[R::kVec];
      R::load_vec(x, i, v);
#pragma unroll
      for (int t = 0; t < R::kVec / 4; ++t) {
        const float4 b = q4[i * (R::kVec / 4) + t];
        qv[4 * t] = b.x;
        qv[4 * t + 1] = b.y;
        qv[4 * t + 2] = b.z;
        qv[4 * t + 3] = b.w;
      }
#pragma unroll
      for (int t = 0; t < R::kVec; ++t) {
        // __fmul_rn: never contracted into the subtraction below
        const float xv = scaled ? __fmul_rn(v[t], s) : v[t];
        if (l2) {
          const float diff = xv - qv[t];
          acc = fmaf(diff, diff, acc);
        } else {
          acc = fmaf(qv[t], xv, acc);
        }
      }
    }
  } else {
    for (int d = lane; d < D; d += 32) {
      float xv = R::load(x, d);
      if (scaled) xv = __fmul_rn(xv, s);
      if (l2) {
        const float diff = xv - q_s[d];
        acc = fmaf(diff, diff, acc);
      } else {
        acc = fmaf(q_s[d], xv, acc);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  return l2 ? acc : 1.f - acc;
}
