// Fused row gather + distance for fp32, bf16 and int8(+scales) rows, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/gather_distance.py
// (gather_distance_pallas / _kernel): for every (query b, candidate k)
// gather row ids[b, k] of vectors [N, D], decode it to fp32 (bf16
// widened; int8 converted and multiplied by its row's scale when a scale
// table is given) and score it against q[b]: 1 - <q, x> for cosine/ip,
// squared L2 for l2, accumulated in fp32. The plain version is
// repro_torch/kernels/ref.py:gather_distance_ref.
//
// What bounds it on this card: bytes. Each (b, k) reads one row (4, 2 or
// 1 byte a dimension, plus a 4-byte scale for int8) from a random place
// in device memory and does 2*D flops on it, far below the card's ~20
// flop/byte fp32 balance point. The TPU kernel hid the row latency with a
// double-buffered DMA wave; here the card hides it with parallelism: one
// warp per (b, k) reads its row with coalesced loads (16-byte vectors per
// lane when the row is a whole number of 16 bytes, row_distance.cuh), and
// a block holds eight such warps for one query, whose q row sits in shared
// memory so that every warp reads it from there instead of device memory.
// A warp-shuffle tree finishes each dot product. An int8 row of 384 bytes
// is 24 16-byte vectors, so 8 lanes idle on its single pass.
//
// Plain C interface (no PyTorch headers), loaded with ctypes. Ids are
// clamped to [0, N) before the load so a bad id cannot fault; callers
// pre-clip and mask invalid slots themselves, as on the TPU.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_distance.cuh"

namespace {

constexpr int kWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
gather_distance_kernel(const T* __restrict__ vectors,
                       const float* __restrict__ scales,
                       const float* __restrict__ q,
                       const int32_t* __restrict__ ids,
                       float* __restrict__ out, int K, int D, int N, int l2,
                       int vec) {
  extern __shared__ float4 q_s4[];  // [D] floats, 16-byte aligned
  float* q_s = reinterpret_cast<float*>(q_s4);
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    q_s[d] = q[(size_t)b * D + d];
  }
  __syncthreads();
  // the loop bound depends on the warp only, so every lane of a warp runs
  // the same iterations and the full-mask shuffles below are safe
  for (int k = warp; k < K; k += kWarps) {
    int row = ids[(size_t)b * K + k];
    row = row < 0 ? 0 : (row >= N ? N - 1 : row);
    const float dist = warp_row_distance<T>(
        vectors + (size_t)row * D, scales == nullptr ? nullptr : scales + row,
        q_s, D, lane, l2, vec);
    if (lane == 0) out[(size_t)b * K + k] = dist;
  }
}

template <typename T>
int launch(const void* vectors, const void* scales, const void* q,
           const void* ids, void* out, int B, int K, int D, int N, int l2,
           int vec, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  const size_t smem = (size_t)D * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gather_distance_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  gather_distance_kernel<T><<<B, kWarps * 32, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(vectors), static_cast<const float*>(scales),
      static_cast<const float*>(q), static_cast<const int32_t*>(ids),
      static_cast<float*>(out), K, D, N, l2, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// vectors [N, D] (f32, bf16 or int8), scales [N] f32 or null, q [B, D]
// f32, ids [B, K] i32 -> out [B, K] f32. l2 = 0 scores 1 - <q, x> (cosine,
// ip), l2 = 1 the squared L2 distance. vec = 1 promises a row of a whole
// number of 16 bytes and a 16-byte-aligned vectors pointer. Each returns
// the launch's cudaError_t (0 on success).
#define GATHER_DISTANCE_ENTRY(NAME, T)                                       \
  extern "C" int NAME(const void* vectors, const void* scales,              \
                      const void* q, const void* ids, void* out, int B,     \
                      int K, int D, int N, int l2, int vec, void* stream) { \
    return launch<T>(vectors, scales, q, ids, out, B, K, D, N, l2, vec,     \
                     stream);                                               \
  }

GATHER_DISTANCE_ENTRY(gather_distance_f32, float)
GATHER_DISTANCE_ENTRY(gather_distance_bf16, __nv_bfloat16)
GATHER_DISTANCE_ENTRY(gather_distance_int8, int8_t)
