// EmbeddingBag for fp32 and bf16 tables, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/embedding_bag.py
// (embedding_bag_pallas / _kernel): for every bag b,
//   out[b] = sum_l w[b, l] * table[ids[b, l]]
// accumulated in fp32 (bf16 rows widened exactly by a shift), then, for
// combine = "mean", divided by max(sum_l w[b, l], 1e-9), or by L when no
// weights are given. Every member's row is read and multiplied by its
// weight, a zero weight too, so a zero-weight member whose row holds NaN
// or Inf makes its bag NaN, as 0 * x does in the reference. Ids are not
// range-checked (they must lie in [0, R)), as on the TPU. The plain
// version is repro_torch/kernels/ref.py:embedding_bag_ref.
//
// What bounds it on this card: bytes. Each member reads one table row
// (E * 4 or E * 2 bytes) from a random place and does 2 * E flops on it,
// and the rows of a bag are independent: the card needs several MB of
// rows in flight to hold its 3.35 TB/s through ~1 us of latency. The
// Pallas kernel hid a row's latency behind double-buffered DMA waves over
// a block of bags. Here:
//   - a warp reads its members' ids and weights once, coalesced (lane i
//     holds member i of a round of 32), and hands each to the lanes that
//     load its row by shuffle, so no id read sits in front of a row load;
//   - the lanes of a warp lie across a row (16-byte loads, 4 fp32 or 8
//     bf16 elements a lane, when the row is a whole number of 16 bytes;
//     element loads otherwise, E 10 on 10 lanes): a row of E 64 takes 16
//     (fp32) or 8 (bf16) lanes, so a warp is G = 2 or 4 lane groups, and
//     each group issues the loads of kInFlight = 4 members before it adds
//     any: 8 or 16 rows in flight a warp, at 4 blocks (32 warps) an SM.
//     On the H100 that beat 8 members a group at 3 blocks an SM (80
//     registers, a few spilled: 11-25 % slower at B 262,144), and 4 to 6
//     members at 5 to 8 blocks (their spills cost 15-40 %);
//   - at a small batch (MIND's serve batch, B 512, is 512 warps: half the
//     132 SMs' worth) a bag's members split over `splits` warps of one
//     block (contiguous ranges), and the block adds their partial sums
//     (and weight sums) from shared memory in warp order; at a large
//     batch a warp takes a whole bag and writes it itself. The ops
//     wrapper's plan (ops._bag_plan) picks the split.
// Summation order: a lane group adds its members in order, the groups add
// group by group into group 0, the splits add in order. It differs from
// the plain version's only in fp32 rounding; sums of integers are exact.
//
// Plain C interface (no PyTorch headers), loaded with ctypes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_distance.cuh"

namespace {

constexpr int kWarps = 8;            // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kMinBlocks = 4;        // blocks an SM: 64 registers a thread
constexpr int kInFlight = 4;         // members a lane group loads at once

// A lane's unit of a row: one 16-byte vector (VEC: K = 4 fp32 or 8 bf16
// elements) or one element (K = 1), loaded raw from global memory and
// widened to fp32 when it is added.
template <typename T, bool VEC>
struct Unit;

template <typename T>
struct Unit<T, true> {
  using Raw = uint4;
  static constexpr int K = SRow<T>::kVec;
  __device__ static Raw load(const T* row, int u) {
    return __ldg(reinterpret_cast<const uint4*>(row) + u);
  }
  __device__ static void widen(const Raw& r, float* x) { SRow<T>::vec(r, x); }
};

template <>
struct Unit<float, false> {
  using Raw = float;
  static constexpr int K = 1;
  __device__ static Raw load(const float* row, int u) { return __ldg(row + u); }
  __device__ static void widen(Raw r, float* x) { x[0] = r; }
};

template <>
struct Unit<__nv_bfloat16, false> {
  using Raw = unsigned short;
  static constexpr int K = 1;
  __device__ static Raw load(const __nv_bfloat16* row, int u) {
    return __ldg(reinterpret_cast<const unsigned short*>(row) + u);
  }
  __device__ static void widen(Raw r, float* x) {
    x[0] = __uint_as_float(static_cast<uint32_t>(r) << 16);
  }
};

struct Args {
  const void* table;       // [R, E]
  const int32_t* ids;      // [B, L]
  const float* weights;    // [B, L] or null
  float* out;              // [B, E]
  int B, L, E, mean, splits;
};

// Warp w of a block takes bag blockIdx.x * (kWarps / splits) + w / splits
// and its members [s L / splits, (s + 1) L / splits), s = w % splits.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
embedding_bag_kernel(const Args a) {
  using U = Unit<T, VEC>;
  constexpr int K = U::K;
  // splits > 1: the warps' sums [kWarps][E], then their weight sums
  extern __shared__ float part[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int splits = a.splits;
  const int bags = kWarps / splits;
  const int b = blockIdx.x * bags + warp / splits;
  const int s = warp - (warp / splits) * splits;
  const bool live = b < a.B;
  const int L = a.L, E = a.E;
  const int lo = static_cast<int>(static_cast<long long>(s) * L / splits);
  const int hi = static_cast<int>(static_cast<long long>(s + 1) * L / splits);
  const int units = E / K;
  const int width = units < 32 ? units : 32;
  const int G = 32 / width;          // lane groups a warp
  const int g = lane / width;        // lanes past G groups idle
  const T* table = static_cast<const T*>(a.table);
  const int32_t* ids_b = a.ids + static_cast<size_t>(b) * L;
  const float* w_b =
      a.weights == nullptr ? nullptr : a.weights + static_cast<size_t>(b) * L;

  float wsum = 0.f;                  // the lane's members' weights
  float denom = 1.f;
  // rows of up to 32 units: one pass; wider rows: G = 1 and a pass a
  // 32 units
  for (int u0 = 0; u0 < units; u0 += width) {
    const int u = u0 + lane % width;
    const bool on = live && g < G && u < units;
    float acc[K];
#pragma unroll
    for (int t = 0; t < K; ++t) acc[t] = 0.f;
    for (int r0 = lo; r0 < hi; r0 += 32) {
      const int n = min(32, hi - r0);
      int my_id = 0;
      float my_w = 1.f;
      if (live && lane < n) {
        my_id = __ldg(ids_b + r0 + lane);
        if (w_b != nullptr) my_w = __ldg(w_b + r0 + lane);
      }
      if (u0 == 0 && live && lane < n) wsum += my_w;
      for (int j0 = 0; j0 < n; j0 += G * kInFlight) {
        typename U::Raw raw[kInFlight];
        float wt[kInFlight];
#pragma unroll
        for (int i = 0; i < kInFlight; ++i) {
          const int j = j0 + i * G + g;       // member r0 + j
          const int id = __shfl_sync(kFull, my_id, j & 31);
          wt[i] = __shfl_sync(kFull, my_w, j & 31);
          if (on && j < n) {
            raw[i] = U::load(table + static_cast<size_t>(id) * E, u);
          }
        }
#pragma unroll
        for (int i = 0; i < kInFlight; ++i) {
          if (on && j0 + i * G + g < n) {
            float x[K];
            U::widen(raw[i], x);
#pragma unroll
            for (int t = 0; t < K; ++t) acc[t] = fmaf(wt[i], x[t], acc[t]);
          }
        }
      }
    }
    if (u0 == 0) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        wsum += __shfl_xor_sync(kFull, wsum, off);
      }
      if (a.mean) {
        denom = w_b != nullptr ? fmaxf(wsum, 1e-9f) : static_cast<float>(L);
      }
    }
    // group 0 adds groups 1 .. G-1 in order; only lanes of group 0 change
    // their sums, so every shuffle reads a finished value
    for (int k = 1; k < G; ++k) {
#pragma unroll
      for (int t = 0; t < K; ++t) {
        const float v = __shfl_down_sync(kFull, acc[t], k * width);
        if (lane < width) acc[t] += v;
      }
    }
    if (lane < width && u < units) {
      if (splits == 1) {
        if (live) {
          float* o = a.out + static_cast<size_t>(b) * E + u * K;
#pragma unroll
          for (int t = 0; t < K; ++t) o[t] = a.mean ? acc[t] / denom : acc[t];
        }
      } else {
#pragma unroll
        for (int t = 0; t < K; ++t) part[warp * E + u * K + t] = acc[t];
      }
    }
  }
  if (splits == 1) return;
  if (lane == 0) part[kWarps * E + warp] = wsum;
  __syncthreads();
  // the block's bags: each element sums its splits' partials in order
  for (int i = threadIdx.x; i < bags * E; i += kThreads) {
    const int bl = i / E;
    const int e = i - bl * E;
    const int bb = blockIdx.x * bags + bl;
    if (bb >= a.B) break;
    const float* p = part + bl * splits * E + e;
    float sum = 0.f;
    for (int k = 0; k < splits; ++k) sum += p[k * E];
    if (a.mean) {
      float d = static_cast<float>(L);
      if (a.weights != nullptr) {
        float ws = 0.f;
        for (int k = 0; k < splits; ++k) {
          ws += part[kWarps * E + bl * splits + k];
        }
        d = fmaxf(ws, 1e-9f);
      }
      sum = sum / d;
    }
    a.out[static_cast<size_t>(bb) * E + e] = sum;
  }
}

__host__ inline size_t smem_bytes(int E, int splits) {
  return splits > 1 ? static_cast<size_t>(kWarps) * (E + 1) * sizeof(float)
                    : 0;
}

template <typename T>
int launch(const Args& a, int vec, void* stream) {
  if (a.B <= 0 || a.E <= 0) return 0;
  const int sp = a.splits;
  if (sp < 1 || sp > kWarps || (sp & (sp - 1)) || a.L < 0 ||
      smem_bytes(a.E, sp) > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bags = kWarps / sp;
  const dim3 grid((a.B + bags - 1) / bags);
  const size_t smem = smem_bytes(a.E, sp);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    embedding_bag_kernel<T, true><<<grid, kThreads, smem, st>>>(a);
  } else {
    embedding_bag_kernel<T, false><<<grid, kThreads, smem, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// table [R, E] (f32 or bf16), ids [B, L] i32 in [0, R), weights [B, L] f32
// or null, out [B, E] f32. mean = 1 divides each bag by max(sum w, 1e-9),
// or by L without weights. vec = 1 promises a row of a whole number of 16
// bytes and a 16-byte-aligned table pointer. splits (1, 2, 4 or 8; with
// 8 (E + 1) floats <= 48 KB when above 1) is the warps a bag, the
// wrapper's plan (ops._bag_plan). Each returns the launch's cudaError_t
// (0 on success).
#define EMBEDDING_BAG_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const void* table, const void* ids,                    \
                      const void* weights, void* out, int B, int L, int E,   \
                      int mean, int vec, int splits, void* stream) {         \
    Args a;                                                                  \
    a.table = table;                                                         \
    a.ids = static_cast<const int32_t*>(ids);                                \
    a.weights = static_cast<const float*>(weights);                          \
    a.out = static_cast<float*>(out);                                        \
    a.B = B; a.L = L; a.E = E; a.mean = mean; a.splits = splits;             \
    return launch<T>(a, vec, stream);                                        \
  }

EMBEDDING_BAG_ENTRY(embedding_bag_f32, float)
EMBEDDING_BAG_ENTRY(embedding_bag_bf16, __nv_bfloat16)
