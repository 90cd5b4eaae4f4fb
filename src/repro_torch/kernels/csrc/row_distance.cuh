// Row decode and the distance of a query to a row, shared by the kernels
// that score (query, row) pairs: gather_distance.cu (the per-hop gather
// and the greedy descent) and beam_search.cu. Every one of them sums a
// pair in the same lane mapping and order, so the same (query, row) pair
// gets the same distance, bit for bit, from each kernel:
//
//   - 16-byte rows (D * sizeof(row) a multiple of 16, a 16-byte-aligned
//     table): lane `lane` sums the row's 16-byte vectors lane, lane + 32,
//     ... in row order, each vector's elements in order (lane_sums_vec);
//   - other rows: lane `lane` sums elements lane, lane + 32, ... in order
//     (lane_sums_elem);
//   - the 32 lane sums are added by the xor tree (lanes l and l ^ 16,
//     then ^ 8, ^ 4, ^ 2, ^ 1); warp_total4 does it for four rows at once.
//
// Rows are fp32, bf16 or int8 (SRow<T> below); an optional per-row scale
// decodes each element as (float)x * scale, the plain version's own
// multiply (ref.gather_distance_ref), before the FMA. The scale is not
// factored out of the dot product: s * sum(q * x) rounds differently
// from sum(q * (x * s)). Each decode is exact: bf16 widens by a shift,
// int8 by a byte permute (int8x4), so the decode has no rounding to
// match. embedding_bag.cu widens its fp32 and bf16 rows with SRow<T>.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr unsigned kFull = 0xffffffffu;
constexpr int kQRegFloats = 16;      // q floats a lane holds (D <= 512)

// ---------------------------------------------------------------------------
// SRow<T>: decode of a 16-byte vector or of one element of a row that lies
// in shared or global memory (a generic pointer)
// ---------------------------------------------------------------------------
// Four int8 in a word, as fp32: x + 128 as the low byte of 2^23's
// mantissa, (2^23 + x + 128) - (2^23 + 128) is x exactly: one byte permute
// and one add, no I2F (which issues at a quarter of the FMA rate). The
// same decode as distance_topk.cu.
__device__ __forceinline__ void int8x4(uint32_t w, float* x) {
  w ^= 0x80808080u;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    x[e] = __uint_as_float(__byte_perm(w, 0x4b00u, 0x5440u | e)) - 8388736.f;
  }
}

// kVec elements a 16-byte vector; vec() decodes one vector, elem() element
// d of a row, both to fp32 and both exact.
template <typename T>
struct SRow;

template <>
struct SRow<float> {
  static constexpr int kVec = 4;
  __device__ static void vec(const uint4 a, float* v) {
    v[0] = __uint_as_float(a.x);
    v[1] = __uint_as_float(a.y);
    v[2] = __uint_as_float(a.z);
    v[3] = __uint_as_float(a.w);
  }
  __device__ static float elem(const unsigned char* row, int d) {
    return reinterpret_cast<const float*>(row)[d];
  }
};

template <>
struct SRow<__nv_bfloat16> {  // the 16 bits become the high half of an fp32
  static constexpr int kVec = 8;
  __device__ static void vec(const uint4 a, float* v) {
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      v[2 * t] = __uint_as_float(w[t] << 16);
      v[2 * t + 1] = __uint_as_float(w[t] & 0xffff0000u);
    }
  }
  __device__ static float elem(const unsigned char* row, int d) {
    const uint32_t u = reinterpret_cast<const unsigned short*>(row)[d];
    return __uint_as_float(u << 16);
  }
};

template <>
struct SRow<int8_t> {
  static constexpr int kVec = 16;
  __device__ static void vec(const uint4 a, float* v) {
    int8x4(a.x, v);
    int8x4(a.y, v + 4);
    int8x4(a.z, v + 8);
    int8x4(a.w, v + 12);
  }
  __device__ static float elem(const unsigned char* row, int d) {
    const uint32_t u = static_cast<uint32_t>(row[d] ^ 0x80u) | 0x4b000000u;
    return __uint_as_float(u) - 8388736.f;
  }
};

// ---------------------------------------------------------------------------
// lane sums and warp totals
// ---------------------------------------------------------------------------
// The query floats lane `lane` multiplies on the 16-byte-row path, into
// qr[kQRegFloats]: vectors lane, lane + 32, ... of q (16-byte aligned, D
// <= 32 * kQRegFloats), zero past the row.
template <typename T>
__device__ __forceinline__ void lane_q_regs(const float* q, int nvec, int lane,
                                            float* qr) {
  constexpr int KV = SRow<T>::kVec;
  const float4* q4 = reinterpret_cast<const float4*>(q);
#pragma unroll
  for (int i = 0; i < kQRegFloats / KV; ++i) {
    const int idx = lane + 32 * i;
#pragma unroll
    for (int t = 0; t < KV / 4; ++t) {
      const float4 v = idx < nvec ? q4[idx * (KV / 4) + t]
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
      qr[i * KV + 4 * t] = v.x;
      qr[i * KV + 4 * t + 1] = v.y;
      qr[i * KV + 4 * t + 2] = v.z;
      qr[i * KV + 4 * t + 3] = v.w;
    }
  }
}

// one element's term: <q, x> (l2 = 0) or |q - x|^2 (l2 = 1)
__device__ __forceinline__ float term(float acc, float v, float q, float s,
                                      bool scaled, int l2) {
  // __fmul_rn: never contracted into the subtraction below
  const float xv = scaled ? __fmul_rn(v, s) : v;
  if (l2) {
    const float diff = xv - q;
    return fmaf(diff, diff, acc);
  }
  return fmaf(q, xv, acc);
}

// Lane `lane`'s share of R rows at once (16-byte vectors, row[j] 16-byte
// aligned): acc[j] sums vectors lane, lane + 32, ... of row j in row
// order. The R rows' loads of one step are issued together, so a warp
// has R rows in flight. QREG: the lane's q floats are in qr (one query
// for every row; nvec <= 32 * kQRegFloats / kVec), else row j's query is
// read as float4 from q[j] (shared memory or global, 16-byte aligned).
template <typename T, bool QREG, int R>
__device__ __forceinline__ void lane_sums_vec(const unsigned char* const* row,
                                              const float* qr,
                                              const float* const* q,
                                              const float* s, bool scaled,
                                              int nvec, int lane, int l2,
                                              float* acc) {
  using S = SRow<T>;
#pragma unroll
  for (int j = 0; j < R; ++j) acc[j] = 0.f;
  if (QREG) {
    constexpr int NV = kQRegFloats / S::kVec;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int idx = lane + 32 * i;
      if (idx < nvec) {
        uint4 a[R];
#pragma unroll
        for (int j = 0; j < R; ++j) a[j] = reinterpret_cast<const uint4*>(row[j])[idx];
#pragma unroll
        for (int j = 0; j < R; ++j) {
          float v[S::kVec];
          S::vec(a[j], v);
#pragma unroll
          for (int t = 0; t < S::kVec; ++t) {
            acc[j] = term(acc[j], v[t], qr[i * S::kVec + t], s[j], scaled, l2);
          }
        }
      }
    }
  } else {
    for (int idx = lane; idx < nvec; idx += 32) {
      uint4 a[R];
#pragma unroll
      for (int j = 0; j < R; ++j) a[j] = reinterpret_cast<const uint4*>(row[j])[idx];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float4* q4 = reinterpret_cast<const float4*>(q[j]);
        float v[S::kVec];
        S::vec(a[j], v);
#pragma unroll
        for (int t = 0; t < S::kVec / 4; ++t) {
          const float4 b = q4[idx * (S::kVec / 4) + t];
          acc[j] = term(acc[j], v[4 * t], b.x, s[j], scaled, l2);
          acc[j] = term(acc[j], v[4 * t + 1], b.y, s[j], scaled, l2);
          acc[j] = term(acc[j], v[4 * t + 2], b.z, s[j], scaled, l2);
          acc[j] = term(acc[j], v[4 * t + 3], b.w, s[j], scaled, l2);
        }
      }
    }
  }
}

// The same for one row whose lane's q floats are in qr (QREG) or at q_s.
template <typename T, bool QREG>
__device__ __forceinline__ float lane_sum_vec(const unsigned char* row,
                                              const float* qr,
                                              const float* q_s, float s,
                                              bool scaled, int nvec,
                                              int lane, int l2) {
  float acc;
  lane_sums_vec<T, QREG, 1>(&row, qr, &q_s, &s, scaled, nvec, lane, l2, &acc);
  return acc;
}

// Lane `lane`'s share of R rows of any width or alignment: acc[j] sums
// elements d = lane, lane + 32, ... of row j, read element by element,
// against q[j][d].
template <typename T, int R>
__device__ __forceinline__ void lane_sums_elem(const unsigned char* const* row,
                                               const float* const* q,
                                               const float* s, bool scaled,
                                               int D, int lane, int l2,
                                               float* acc) {
#pragma unroll
  for (int j = 0; j < R; ++j) acc[j] = 0.f;
  for (int d = lane; d < D; d += 32) {
    float x[R];
#pragma unroll
    for (int j = 0; j < R; ++j) x[j] = SRow<T>::elem(row[j], d);
#pragma unroll
    for (int j = 0; j < R; ++j) acc[j] = term(acc[j], x[j], q[j][d], s[j], scaled, l2);
  }
}

template <typename T>
__device__ __forceinline__ float lane_sum_elem(const unsigned char* row,
                                               const float* q_s, float s,
                                               bool scaled, int D, int lane,
                                               int l2) {
  float acc;
  lane_sums_elem<T, 1>(&row, &q_s, &s, scaled, D, lane, l2, &acc);
  return acc;
}

// The warp totals of four rows' lane sums: a reduce-scatter over the xor
// tree (lanes l and l ^ 16 first, then ^ 8, ^ 4, ^ 2, ^ 1). Each addition
// pairs the same two partial sums as that tree, so the totals are its
// totals bit for bit; row j's lands in lanes 8 j .. 8 j + 7.
__device__ __forceinline__ float warp_total4(const float* acc, int lane) {
  const bool hi16 = (lane & 16) != 0;
  const bool hi8 = (lane & 8) != 0;
  float k0 = hi16 ? acc[2] : acc[0];
  float k1 = hi16 ? acc[3] : acc[1];
  const float s0 = hi16 ? acc[0] : acc[2];
  const float s1 = hi16 ? acc[1] : acc[3];
  k0 += __shfl_xor_sync(kFull, s0, 16);
  k1 += __shfl_xor_sync(kFull, s1, 16);
  float t = hi8 ? k1 : k0;
  t += __shfl_xor_sync(kFull, hi8 ? k0 : k1, 8);
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) t += __shfl_xor_sync(kFull, t, off);
  return t;
}
