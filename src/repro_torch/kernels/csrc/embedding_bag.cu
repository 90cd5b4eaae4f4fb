// EmbeddingBag for fp32 and bf16 tables, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/embedding_bag.py
// (embedding_bag_pallas / _kernel): for every bag b,
//   out[b] = sum_l w[b, l] * table[ids[b, l]]
// accumulated in fp32 (bf16 rows widened exactly by a shift), then, for
// combine = "mean", divided by max(sum_l w[b, l], 1e-9), or by L when no
// weights are given. The plain version is
// repro_torch/kernels/ref.py:embedding_bag_ref.
//
// What bounds it on this card: bytes. Each member reads one table row
// (E * 4 or E * 2 bytes) from a random place and does 2 * E flops on it.
// The Pallas kernel hid a row's latency behind double-buffered DMA waves
// over a block of bags; here many bags in flight hide it: one warp per
// bag, eight bags to a block. The lanes of a warp lie across the row:
// 16-byte vector loads (4 fp32 or 8 bf16 elements a lane) when the row is
// a whole number of 16 bytes, scalar loads otherwise (E 10 uses 10 lanes
// a member). When a row takes fewer than 32 lanes, the warp splits into
// G = 32 / width groups that walk the members l = g, g + G, ... at once,
// and a shuffle chain adds the groups' sums at the end. Each lane reads
// the next member's id and weight before it loads the current row. Ids
// are not range-checked (they must lie in [0, R)), as on the TPU.
//
// Plain C interface (no PyTorch headers), loaded with ctypes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_distance.cuh"

namespace {

constexpr int kWarps = 8;

// K fp32 sums a lane holds: one 16-byte vector of the row, or one element
template <typename T, bool kVecLoads>
struct Unit {
  static constexpr int K = kVecLoads ? Row<T>::kVec : 1;
  __device__ static void load(const T* row, int u, float* x) {
    if constexpr (kVecLoads) {
      Row<T>::load_vec(row, u, x);
    } else {
      x[0] = Row<T>::load(row, u);
    }
  }
};

template <typename T, bool kVecLoads>
__global__ void __launch_bounds__(kWarps * 32)
embedding_bag_kernel(const T* __restrict__ table,
                     const int32_t* __restrict__ ids,
                     const float* __restrict__ weights,
                     float* __restrict__ out, int B, int L, int E,
                     int mean) {
  using U = Unit<T, kVecLoads>;
  constexpr int K = U::K;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp leaves together
  const int units = E / K;
  const int width = units < 32 ? units : 32;
  const int G = 32 / width;
  const int g = lane / width;
  const int32_t* ids_b = ids + (size_t)b * L;
  const float* w_b = weights == nullptr ? nullptr : weights + (size_t)b * L;
  float* out_b = out + (size_t)b * E;

  float denom = 1.f;
  if (mean) {
    if (w_b == nullptr) {
      denom = (float)L;
    } else {
      float s = 0.f;
      for (int l = lane; l < L; l += 32) s += w_b[l];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
      }
      denom = fmaxf(s, 1e-9f);
    }
  }

  // units <= 32: one pass, every lane of a group on its own unit; wider
  // rows: G = 1 and each lane takes units lane, lane + 32, ...
  for (int u0 = 0; u0 < units; u0 += width) {
    const int u = u0 + lane % width;
    float acc[K];
#pragma unroll
    for (int t = 0; t < K; ++t) acc[t] = 0.f;
    if (g < G && u < units) {
      int l = g;
      int id = l < L ? ids_b[l] : 0;
      float w = (w_b != nullptr && l < L) ? w_b[l] : 1.f;
      while (l < L) {
        const int ln = l + G;
        const int id_n = ln < L ? ids_b[ln] : 0;  // read ahead
        const float w_n = (w_b != nullptr && ln < L) ? w_b[ln] : 1.f;
        float x[K];
        U::load(table + (size_t)id * E, u, x);
#pragma unroll
        for (int t = 0; t < K; ++t) acc[t] = fmaf(w, x[t], acc[t]);
        l = ln;
        id = id_n;
        w = w_n;
      }
    }
    // group 0 adds groups 1 .. G-1 in order; only lanes of group 0 change
    // their sums, so every shuffle reads a finished value
    for (int s = 1; s < G; ++s) {
#pragma unroll
      for (int t = 0; t < K; ++t) {
        const float v = __shfl_down_sync(0xffffffffu, acc[t], s * width);
        if (lane < width) acc[t] += v;
      }
    }
    if (lane < width && u < units) {
#pragma unroll
      for (int t = 0; t < K; ++t) {
        out_b[u * K + t] = mean ? acc[t] / denom : acc[t];
      }
    }
  }
}

template <typename T>
int launch(const void* table, const void* ids, const void* weights, void* out,
           int B, int L, int E, int mean, int vec, void* stream) {
  if (B <= 0 || E <= 0) return 0;
  const dim3 grid((B + kWarps - 1) / kWarps);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* t = static_cast<const T*>(table);
  const int32_t* i = static_cast<const int32_t*>(ids);
  const float* w = static_cast<const float*>(weights);
  float* o = static_cast<float*>(out);
  if (vec) {
    embedding_bag_kernel<T, true><<<grid, kWarps * 32, 0, s>>>(t, i, w, o, B,
                                                                L, E, mean);
  } else {
    embedding_bag_kernel<T, false><<<grid, kWarps * 32, 0, s>>>(t, i, w, o, B,
                                                                 L, E, mean);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// table [R, E] (f32 or bf16), ids [B, L] i32 in [0, R), weights [B, L] f32
// or null, out [B, E] f32. mean = 1 divides each bag by max(sum w, 1e-9),
// or by L without weights. vec = 1 promises a row of a whole number of 16
// bytes and a 16-byte-aligned table pointer. Each returns the launch's
// cudaError_t (0 on success).
#define EMBEDDING_BAG_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const void* table, const void* ids,                    \
                      const void* weights, void* out, int B, int L, int E,   \
                      int mean, int vec, void* stream) {                     \
    return launch<T>(table, ids, weights, out, B, L, E, mean, vec, stream);  \
  }

EMBEDDING_BAG_ENTRY(embedding_bag_f32, float)
EMBEDDING_BAG_ENTRY(embedding_bag_bf16, __nv_bfloat16)
