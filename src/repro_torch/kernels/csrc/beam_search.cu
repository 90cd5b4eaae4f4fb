// Whole layer-0 HNSW ef-beam search in one launch, fp32, bf16 or
// int8(+scales) rows, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/beam_search.py
// (beam_search_pallas / _kernel). The plain version, with the same
// frontier selection, dedup and merge, is
// repro_torch/kernels/ref.py:beam_search_ref.
//
// One thread block runs one query's whole search. The beam — efp =
// next_pow2(ef) (distance, id, expanded) triples, ascending by (d, id) —
// lives in shared memory from the first hop to the last. Each hop:
//   1. selects the first t_live = min(T, budget - hop*T) unexpanded
//      entries (warp 0: a ballot + popcount prefix over the beam) and
//      marks them expanded; no unexpanded entry left ends the search;
//   2. loads their 2M-wide neighbor lists (T*2M candidates);
//   3. keeps a candidate only if its list slot is not -1 padding, its id
//      is not already in the beam, and no earlier valid slot holds the
//      same id (ref.beam_dedup_valid);
//   4. computes each kept candidate's distance, one warp per row, with
//      the same decode and summation order as gather_distance.cu
//      (row_distance.cuh): bf16 widened, int8 multiplied by its row's
//      scale, read with the row, element by element before the FMA;
//   5. bitonic-sorts the candidates DESCENDING by (d, id) and
//      bitonic-merges them with the ascending beam (beam | INF plateau |
//      candidates is bitonic); entries past ef reset to (INF, -1).
// The hop count follows beam_search.py:_call exactly: budget = ef (+ T
// when T > 1) unless max_iters is given, hops = ceil(budget / T). At T = 1
// the visit order is the one-at-a-time search of core/hnsw.py.
//
// What bounds it on this card: bytes, and their latency. Every hop reads
// up to T*2M random rows (4, 2 or 1 byte a dimension, plus a 4-byte scale
// for int8) for 2*D flops each. The TPU kernel
// double-buffered its row DMAs inside one core; here the card keeps many
// queries' blocks resident per SM, so one block's row loads overlap the
// others' sort and merge phases, and every row is read with coalesced
// 128-byte warp loads. The search state never leaves shared memory.
//
// Plain C interface (no PyTorch headers), loaded with ctypes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_distance.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kInf = 3.0e38f;

__device__ __forceinline__ bool le_key(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia <= ib);
}

__device__ __forceinline__ void swap3(float* d, int* i, int* x, int a, int b) {
  const float td = d[a];
  d[a] = d[b];
  d[b] = td;
  const int ti = i[a];
  i[a] = i[b];
  i[b] = ti;
  const int tx = x[a];
  x[a] = x[b];
  x[b] = tx;
}

__device__ __forceinline__ int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

template <typename RowT>
__global__ void __launch_bounds__(kThreads)
beam_search_kernel(const RowT* __restrict__ vectors,      // [N, D]
                   const float* __restrict__ scales,      // [N] or null
                   const int32_t* __restrict__ nbrs,      // [N, m2]
                   const float* __restrict__ q,           // [B, D]
                   const int32_t* __restrict__ ep,        // [B]
                   const float* __restrict__ ep_dist,     // [B]
                   int32_t* __restrict__ out_ids,         // [B, ef]
                   float* __restrict__ out_d,             // [B, ef]
                   int N, int D, int m2, int ef, int efp, int T, int budget,
                   int hops, int l2, int vec) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int w = T * m2;            // candidates per hop
  const int wp = next_pow2(w);     // candidate sort width
  const int W = next_pow2(efp + wp);  // merge width
  const int cbase = W - wp;        // candidates sit at the merge tail

  extern __shared__ float4 smem4[];                   // 16-byte aligned
  float* q_s = reinterpret_cast<float*>(smem4);        // [D]
  float* bd = q_s + D;                                 // [efp]
  int* bi = reinterpret_cast<int*>(bd + efp);          // [efp]
  int* bx = bi + efp;                                  // [efp]
  float* md = reinterpret_cast<float*>(bx + efp);      // [W]
  int* mi = reinterpret_cast<int*>(md + W);            // [W]
  int* mx = mi + W;                                    // [W]
  int* cand = mx + W;                                  // [w]
  int* valid0 = cand + w;                              // [w]
  int* valid = valid0 + w;                             // [w]
  int* nodes = valid + w;                              // [T]
  int* flags = nodes + T;                              // [1]

  for (int d = tid; d < D; d += blockDim.x) q_s[d] = q[(size_t)b * D + d];
  for (int p = tid; p < efp; p += blockDim.x) {
    bd[p] = p == 0 ? ep_dist[b] : kInf;
    bi[p] = p == 0 ? ep[b] : -1;
    bx[p] = p != 0;
  }
  __syncthreads();

  for (int hop = 0; hop < hops; ++hop) {
    // 1. frontier: the first t_live unexpanded entries, in beam order
    if (warp == 0) {
      const int t_live = min(T, budget - hop * T);
      int running = 0;
      for (int base = 0; base < efp; base += 32) {
        const int p = base + lane;
        const bool un = p < efp && bx[p] == 0 && bi[p] >= 0;
        const unsigned mask = __ballot_sync(0xffffffffu, un);
        const int rank = running + __popc(mask & ((1u << lane) - 1u));
        if (un && rank < t_live) {
          nodes[rank] = bi[p];
          bx[p] = 1;
        }
        running += __popc(mask);
      }
      const int nsel = min(running, t_live);
      for (int j = lane; j < T; j += 32) {
        if (j >= nsel) nodes[j] = -1;
      }
      if (lane == 0) flags[0] = running > 0;
    }
    __syncthreads();
    if (!flags[0]) break;  // no frontier left: the search has converged

    // 2. neighbor lists of the selected nodes
    for (int c = tid; c < w; c += blockDim.x) {
      const int j = c / m2, e = c - (c / m2) * m2;
      const int node = nodes[j];
      int nb = -1;
      if (node >= 0) {
        const int row = node >= N ? N - 1 : node;
        nb = nbrs[(size_t)row * m2 + e];
      }
      valid0[c] = nb >= 0;
      cand[c] = nb < 0 ? 0 : (nb >= N ? N - 1 : nb);
    }
    __syncthreads();

    // 3. dedup against the beam and against earlier valid slots
    for (int c = tid; c < w; c += blockDim.x) {
      bool ok = valid0[c] != 0;
      const int id = cand[c];
      for (int p = 0; ok && p < efp; ++p) ok = bi[p] != id;
      for (int c2 = 0; ok && c2 < c; ++c2) ok = !(valid0[c2] && cand[c2] == id);
      valid[c] = ok;
    }
    // the merge buffer: beam | INF plateau | candidate slots
    for (int p = tid; p < cbase; p += blockDim.x) {
      if (p < efp) {
        md[p] = bd[p];
        mi[p] = bi[p];
        mx[p] = bx[p];
      } else {
        md[p] = kInf;
        mi[p] = -1;
        mx[p] = 1;
      }
    }
    __syncthreads();

    // 4. candidate distances, one warp per row
    for (int r = warp; r < wp; r += nwarps) {
      float dist = kInf;
      int id = -1;
      if (r < w && valid[r]) {
        id = cand[r];
        dist = warp_row_distance<RowT>(
            vectors + (size_t)id * D,
            scales == nullptr ? nullptr : scales + id, q_s, D, lane, l2, vec);
      }
      if (lane == 0) {
        md[cbase + r] = dist;
        mi[cbase + r] = id;
        mx[cbase + r] = 0;
      }
    }
    __syncthreads();

    // 5a. bitonic sort of the candidate slots, descending by (d, id)
    float* cd = md + cbase;
    int* ci = mi + cbase;
    int* cx = mx + cbase;
    for (int size = 2; size <= wp; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int i = tid; i < (wp >> 1); i += blockDim.x) {
          const int lo = (i / stride) * 2 * stride + (i % stride);
          const int hi = lo + stride;
          // block direction of the reference network, descending overall
          const bool asc = (lo & size) != 0;
          const bool ordered = le_key(cd[lo], ci[lo], cd[hi], ci[hi]);
          if (asc ? !ordered : !le_key(cd[hi], ci[hi], cd[lo], ci[lo])) {
            swap3(cd, ci, cx, lo, hi);
          }
        }
        __syncthreads();
      }
    }
    // 5b. bitonic merge of beam | plateau | candidates, ascending
    for (int stride = W >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < (W >> 1); i += blockDim.x) {
        const int lo = (i / stride) * 2 * stride + (i % stride);
        const int hi = lo + stride;
        if (!le_key(md[lo], mi[lo], md[hi], mi[hi])) swap3(md, mi, mx, lo, hi);
      }
      __syncthreads();
    }
    // keep the first ef entries; the rest of the efp slots are empty
    for (int p = tid; p < efp; p += blockDim.x) {
      const bool live = p < ef;
      bd[p] = live ? md[p] : kInf;
      bi[p] = live ? mi[p] : -1;
      bx[p] = live ? mx[p] : 1;
    }
    __syncthreads();
  }

  for (int p = tid; p < ef; p += blockDim.x) {
    out_ids[(size_t)b * ef + p] = bi[p];
    out_d[(size_t)b * ef + p] = bd[p];
  }
}

template <typename RowT>
int launch(const void* vectors, const void* scales, const void* nbrs,
           const void* q, const void* ep, const void* ep_dist, void* out_ids,
           void* out_d, int B, int N, int D, int m2, int ef, int efp, int t,
           int budget, int hops, int l2, int vec, void* stream) {
  if (B <= 0) return 0;
  int wp = 1;
  while (wp < t * m2) wp <<= 1;
  int W = 1;
  while (W < efp + wp) W <<= 1;
  const int w = t * m2;
  const size_t smem = sizeof(float) * (size_t)D + (size_t)efp * 12 +
                      (size_t)W * 12 + (size_t)w * 12 + (size_t)t * 4 + 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        beam_search_kernel<RowT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  beam_search_kernel<RowT><<<B, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const RowT*>(vectors), static_cast<const float*>(scales),
      static_cast<const int32_t*>(nbrs), static_cast<const float*>(q),
      static_cast<const int32_t*>(ep), static_cast<const float*>(ep_dist),
      static_cast<int32_t*>(out_ids), static_cast<float*>(out_d), N, D, m2,
      ef, efp, t, budget, hops, l2, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// vectors [N, D] (f32, bf16 or int8), scales [N] f32 or null, nbrs [N, m2]
// i32 (-1 pad), q [B, D] f32, ep [B] i32, ep_dist [B] f32 -> out_ids
// [B, ef] i32, out_d [B, ef] f32. efp = next_pow2(ef); T, budget, hops as
// ref.beam_schedule gives them; l2 = 1 for squared L2, 0 for 1 - <q, x>;
// vec = 1 promises a row of a whole number of 16 bytes and a
// 16-byte-aligned vectors pointer. Each returns the launch's cudaError_t
// (0 on success).
#define BEAM_SEARCH_ENTRY(NAME, RowT)                                        \
  extern "C" int NAME(const void* vectors, const void* scales,             \
                      const void* nbrs, const void* q, const void* ep,     \
                      const void* ep_dist, void* out_ids, void* out_d,     \
                      int B, int N, int D, int m2, int ef, int efp,        \
                      int T, int budget, int hops, int l2, int vec,        \
                      void* stream) {                                      \
    return launch<RowT>(vectors, scales, nbrs, q, ep, ep_dist, out_ids,    \
                        out_d, B, N, D, m2, ef, efp, T, budget, hops, l2,  \
                        vec, stream);                                      \
  }

BEAM_SEARCH_ENTRY(beam_search_f32, float)
BEAM_SEARCH_ENTRY(beam_search_bf16, __nv_bfloat16)
BEAM_SEARCH_ENTRY(beam_search_int8, int8_t)
