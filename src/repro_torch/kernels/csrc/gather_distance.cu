// Fused row gather + distance for fp32, bf16 and int8(+scales) rows, for
// NVIDIA Hopper (sm_90a): the per-hop gather, and the whole upper-layer
// greedy descent of an HNSW search in one launch.
//
// Replaces the TPU kernel repro/kernels/gather_distance.py
// (gather_distance_pallas / _kernel), and, in the descent, the
// jax.lax.while_loop around it (repro/core/hnsw.py:_greedy_layer). For a
// (query b, row id) pair: decode row id of vectors [N, D] to fp32 (bf16
// widened; int8 by byte permute, then multiplied by its row's scale when
// a scale table is given) and score it against q[b]: 1 - <q, x> for
// cosine/ip, squared L2 for l2, accumulated in fp32 in the lane mapping
// and order of row_distance.cuh, so that beam_search.cu gives every pair
// the same distance bit for bit. Plain versions:
// repro_torch/kernels/ref.py:gather_distance_ref and greedy_descent_ref.
//
// What bounds them on this card. The hop kernel reads one row (4, 2 or 1
// byte a dimension, plus a 4-byte scale for int8) from a random place for
// each (b, k) and does 2 D flops on it: bytes, far below the card's ~20
// flop/byte fp32 balance point, and, at the shapes the search launches
// (B 8 x K 16, B 1024 x K 5), the latency of two dependent reads (ids,
// then rows). A descent hop reads one list of M ids, then the M rows it
// names, then picks the best: two dependent round trips a hop, some tens
// of hops a search, each far below a microsecond of bytes. Run as one
// launch a hop with a host-side loop condition, the launches, the ~10
// small PyTorch ops around each and the host read of the condition set
// the pace, not the bytes.
//
// The design:
//   - hop kernel (gather_distance_kernel): the (b, k) pairs spread over
//     the grid, four of one query a warp, so that the warps reach the
//     SMs at B 8 x K 16 (32 warps) and B 1024 x K 5 (2,048). A warp issues
//     its four rows' loads together and reduces the four lane sums at
//     once (warp_total4); the query's floats sit in the lane's registers
//     (D <= 512), else are read through L1. No shared memory, no block
//     barrier: warps leave as soon as their pairs are scored. The ops
//     wrapper's plan (ops._gather_plan) picks the warps a block;
//   - greedy descent (greedy_descent_kernel): one block a query runs
//     every layer max_level .. 1 and every hop on the device, with no
//     host sync. A hop: the threads of the first warp(s) read the list
//     (one slot a thread, one 64-byte read at M 16) and each valid
//     slot's thread issues one cp.async.bulk of its row into a shared
//     ring (one mbarrier), so every row of the hop is in flight at once;
//     each warp scores four slots from the ring (slots 4 w + j; past M
//     128, where the block has its 32 warps, again every 128 slots),
//     reduces its best (d, slot), and one block barrier later every
//     thread holds the block's best and the same loop state. A query
//     stops as soon as it does not improve: the lock-step loop of the
//     reference leaves such a query at a fixed point (it reads the same
//     list and finds the same best), so the result is the lock-step
//     result. Rows that are not a whole number of 16 bytes, a
//     misaligned table, or a hop too wide for the ring, are read
//     straight from global memory in the same order.
//
// Semantics of a descent hop, as core/hnsw.py:_greedy_layer: the list is
// upper[layer - 1][ep]; ids clamp to [0, N); a slot with id < 0 scores
// INF (3e38); the argmin takes the lowest slot among equal distances
// (NaN below everything, as torch.argmin); the query moves only if
// best_d < ep_dist.
//
// Plain C interface (no PyTorch headers), loaded with ctypes. Ids are
// clamped to [0, N) before a load so a bad id cannot fault.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"
#include "row_distance.cuh"

namespace {

constexpr int kHopMaxThreads = 256;
constexpr int kDescentMaxThreads = 1024;   // 32 warps: 128 slots a round
constexpr float kInf = 3.0e38f;            // == core.hnsw.INF
constexpr int kSmemOptIn = 227 * 1024;

__host__ __device__ inline size_t round16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// ---------------------------------------------------------------------------
// hop kernel
// ---------------------------------------------------------------------------
struct HopArgs {
  const void* vectors;     // [N, D] row type
  const float* scales;     // [N] or null
  const float* q;          // [B, D], 16-byte aligned
  const int32_t* ids;      // [B, K]
  float* out;              // [B, K]
  int B, K, D, N, l2;
};

// A warp scores one query's pairs k0 .. k0 + 3 (fewer at the end of its
// K): the query's floats in registers (QREG: 16-byte rows, D <= 512),
// else read through L1. VEC: 16-byte rows.
template <typename T, bool QREG, bool VEC>
__global__ void __launch_bounds__(kHopMaxThreads)
gather_distance_kernel(const HopArgs a) {
  const int lane = threadIdx.x & 31;
  const int groups = (a.K + 3) / 4;             // warps a query
  const long long g =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (g >= static_cast<long long>(a.B) * groups) return;   // the whole warp
  const int b = static_cast<int>(g / groups);
  const int k0 = static_cast<int>(g - static_cast<long long>(b) * groups) * 4;
  const long long p0 = static_cast<long long>(b) * a.K + k0;
  const int live = min(4, a.K - k0);
  const bool scaled = a.scales != nullptr;
  const int D = a.D;
  // lane j < live reads pair p0 + j's id; a slot past the last pair
  // scores pair p0's row again and is not written. Every lane loads the
  // four scales itself, so that no shuffle waits on them before the rows
  // are requested.
  int id = 0;
  if (lane < live) {
    const int r = __ldg(a.ids + p0 + lane);
    id = r < 0 ? 0 : (r >= a.N ? a.N - 1 : r);
  }
  const T* vectors = static_cast<const T*>(a.vectors);
  const float* q = a.q + static_cast<size_t>(b) * D;
  const unsigned char* row[4];
  const float* qp[4] = {q, q, q, q};
  float s[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int rid = __shfl_sync(kFull, id, j < live ? j : 0);
    row[j] = reinterpret_cast<const unsigned char*>(
        vectors + static_cast<size_t>(rid) * D);
    s[j] = scaled ? __ldg(a.scales + rid) : 1.f;
  }
  float acc[4];
  if (VEC) {
    const int nvec = static_cast<int>(D * sizeof(T) / 16);
    float qr[QREG ? kQRegFloats : 1];
    if (QREG) lane_q_regs<T>(q, nvec, lane, qr);
    lane_sums_vec<T, QREG, 4>(row, qr, qp, s, scaled, nvec, lane, a.l2, acc);
  } else {
    lane_sums_elem<T, 4>(row, qp, s, scaled, D, lane, a.l2, acc);
  }
  const float tot = warp_total4(acc, lane);
  const int r = lane >> 3;
  if ((lane & 7) == 0 && r < live) a.out[p0 + r] = a.l2 ? tot : 1.f - tot;
}

// ---------------------------------------------------------------------------
// greedy descent
// ---------------------------------------------------------------------------
struct DescentArgs {
  const void* vectors;     // [N, D] row type
  const float* scales;     // [N] or null
  const int32_t* upper;    // [L, N, M], -1 pad
  const float* q;          // [B, D], 16-byte aligned
  const int32_t* ep_in;    // [B]
  const float* epd_in;     // [B]
  int32_t* ep_out;         // [B]
  float* epd_out;          // [B]
  int N, D, M, max_level, l2;
  int ring;                // 1: the hop's rows are staged in shared memory
};

// Shared-memory layout of a descent block (byte offsets); ops._descent_plan
// computes the same total: the ring (M rows of D * sizeof(row) rounded up
// to 16, when staged), the mbarrier, the list (M ids) and its scales, and
// each warp's best (d, slot, id) for two hops.
struct DescentLayout {
  size_t ring, mbar, nb, scale, part, total;
  int stride;
};

__host__ __device__ inline DescentLayout descent_layout(int D, int es, int M,
                                                        int ring) {
  DescentLayout L;
  L.stride = static_cast<int>(round16(static_cast<size_t>(D) * es));
  size_t off = 0;
  L.ring = off;  off += ring ? static_cast<size_t>(M) * L.stride : 0;
  L.mbar = off;  off += 16;
  L.nb = off;    off += round16(static_cast<size_t>(M) * 4);
  L.scale = off; off += round16(static_cast<size_t>(M) * 4);
  L.part = off;  off += 2 * 32 * 12;
  L.total = off;
  return L;
}

// (d1, r1) before (d2, r2): a smaller distance (NaN below every number, as
// torch.argmin takes it), then the lower slot; slot -1 is no slot.
__device__ __forceinline__ bool before(float d1, int r1, float d2, int r2) {
  if (r1 < 0) return false;
  if (r2 < 0) return true;
  const bool n1 = d1 != d1, n2 = d2 != d2;
  if (n1 != n2) return n1;
  if (!n1 && d1 != d2) return d1 < d2;
  return r1 < r2;
}

// QREG: q in registers (16-byte rows, D <= 512); VEC: 16-byte rows;
// ROUNDS: M > 128, the block's 32 warps take the list in rounds (else a
// warp's four slots are the whole of its share, scored once: the round
// loop, run once, cost the served descent ~8 % on the H100).
template <typename T, bool QREG, bool VEC, bool ROUNDS>
__global__ void __launch_bounds__(kDescentMaxThreads)
greedy_descent_kernel(const DescentArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.D, M = a.M, N = a.N;
  const DescentLayout L = descent_layout(D, sizeof(T), M, a.ring);
  unsigned char* ring = smem + L.ring;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.mbar);
  int* cnb = reinterpret_cast<int*>(smem + L.nb);
  float* cscale = reinterpret_cast<float*>(smem + L.scale);
  float* part_d = reinterpret_cast<float*>(smem + L.part);   // [2][32]
  int* part_r = reinterpret_cast<int*>(part_d + 64);
  int* part_i = part_r + 64;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int list_warps = ROUNDS ? min(nw, (M + 31) / 32) : (M + 31) / 32;
  const bool scaled = a.scales != nullptr;
  const uint32_t rowb = static_cast<uint32_t>(D * sizeof(T));
  const int nvec = static_cast<int>(rowb / 16);
  const T* vectors = static_cast<const T*>(a.vectors);
  const float* q = a.q + static_cast<size_t>(b) * D;

  float qr[QREG ? kQRegFloats : 1];
  if (QREG) lane_q_regs<T>(q, nvec, lane, qr);
  if (tid == 0) {
    mbar_init(bar, list_warps);       // lane 0 of each list warp arrives
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // every thread holds the same loop state
  int ep = a.ep_in[b];
  float epd = a.epd_in[b];
  uint32_t parity = 0;
  int hb = 0;                         // which of the two hops' partials
  const float* qv[4] = {q, q, q, q};
  for (int layer = a.max_level; layer >= 1; --layer) {
    const int32_t* table = a.upper + static_cast<size_t>(layer - 1) * N * M;
    for (;;) {
      // -- 1. the list (slot c = tid; in rounds, tid + 32 list_warps,
      //    ...), its scales, the rows in flight
      if (warp < list_warps) {
        const int e = ep < 0 ? 0 : (ep >= N ? N - 1 : ep);
        const int32_t* list = table + static_cast<size_t>(e) * M;
        auto take = [&](int c) {
          int nb = -1;
          if (c < M) nb = __ldg(list + c);
          const int id = nb < 0 ? 0 : (nb >= N ? N - 1 : nb);
          if (c < M) cnb[c] = nb;
          if (VEC && a.ring) {
            const unsigned m = __ballot_sync(kFull, nb >= 0);
            if (lane == 0 && m) mbar_expect_tx(bar, __popc(m) * rowb);
            __syncwarp();
            if (nb >= 0) {
              bulk_copy(ring + static_cast<size_t>(c) * L.stride,
                        vectors + static_cast<size_t>(id) * D, rowb, bar);
            }
          }
          // the scale's read waits here, after the row is requested
          if (scaled && c < M) {
            cscale[c] = nb >= 0 ? __ldg(a.scales + id) : 1.f;
          }
        };
        if (ROUNDS) {
          for (int c0 = 32 * warp; c0 < M; c0 += 32 * list_warps) {
            take(c0 + lane);
          }
        } else {
          take(tid);
        }
        __syncwarp();                 // the warp's stores, before its arrival
        if (lane == 0) mbar_arrive(bar);
      }
      mbar_wait(bar, parity);
      parity ^= 1u;

      // -- 2. distances, a warp four slots at a time (slots r0 .. r0 + 3,
      //    r0 = 4 warp, then in rounds + 4 nw, ...); the warp's best
      auto score4 = [&](int r0, float& d, int& r, int& id) {
        const unsigned char* row[4];
        float s[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int rj = r0 + j < M ? r0 + j : r0;
          const int nb = cnb[rj];
          const int rid = nb < 0 ? 0 : (nb >= N ? N - 1 : nb);
          row[j] = (VEC && a.ring)
                       ? ring + static_cast<size_t>(rj) * L.stride
                       : reinterpret_cast<const unsigned char*>(
                             vectors + static_cast<size_t>(rid) * D);
          s[j] = scaled ? cscale[rj] : 1.f;
        }
        float acc[4];
        if (VEC) {
          lane_sums_vec<T, QREG, 4>(row, qr, qv, s, scaled, nvec, lane, a.l2,
                                    acc);
        } else {
          lane_sums_elem<T, 4>(row, qv, s, scaled, D, lane, a.l2, acc);
        }
        const float tot = warp_total4(acc, lane);
        r = r0 + (lane >> 3);
        d = kInf;
        id = 0;
        if (r < M) {
          const int nb = cnb[r];
          id = nb < 0 ? 0 : (nb >= N ? N - 1 : nb);
          if (nb >= 0) d = a.l2 ? tot : 1.f - tot;
        } else {
          r = -1;
        }
      };
      float d;
      int r, id;
      score4(4 * warp, d, r, id);
      if (ROUNDS) {
        for (int r0 = 4 * warp + 4 * nw; r0 < M; r0 += 4 * nw) {
          float dd;
          int rr, ii;
          score4(r0, dd, rr, ii);
          if (before(dd, rr, d, r)) {
            d = dd;
            r = rr;
            id = ii;
          }
        }
      }
#pragma unroll
      for (int off = 8; off <= 16; off <<= 1) {
        const float od = __shfl_xor_sync(kFull, d, off);
        const int orr = __shfl_xor_sync(kFull, r, off);
        const int oid = __shfl_xor_sync(kFull, id, off);
        if (before(od, orr, d, r)) {
          d = od;
          r = orr;
          id = oid;
        }
      }
      if (lane == 0) {
        part_d[hb * 32 + warp] = d;
        part_r[hb * 32 + warp] = r;
        part_i[hb * 32 + warp] = id;
      }
      __syncthreads();

      // -- 3. the block's best, the same in every thread (before() breaks
      //    ties by slot, so the warps' order does not matter)
      float bd = part_d[hb * 32];
      int br = part_r[hb * 32];
      int bi = part_i[hb * 32];
      for (int w = 1; w < nw; ++w) {
        const float od = part_d[hb * 32 + w];
        const int orr = part_r[hb * 32 + w];
        if (before(od, orr, bd, br)) {
          bd = od;
          br = orr;
          bi = part_i[hb * 32 + w];
        }
      }
      hb ^= 1;
      if (!(bd < epd)) break;         // no improvement: this layer is done
      ep = bi;
      epd = bd;
    }
  }
  if (tid == 0) {
    a.ep_out[b] = ep;
    a.epd_out[b] = epd;
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
__host__ inline int qreg_of(int D, int vec) { return vec && D <= 32 * kQRegFloats; }

template <typename T>
int launch_hop(const HopArgs& a, int threads, int blocks, int vec,
               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (qreg_of(a.D, vec)) {
    gather_distance_kernel<T, true, true><<<blocks, threads, 0, st>>>(a);
  } else if (vec) {
    gather_distance_kernel<T, false, true><<<blocks, threads, 0, st>>>(a);
  } else {
    gather_distance_kernel<T, false, false><<<blocks, threads, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// The instance a descent takes: 0 element reads, 1 16-byte rows with q
// read through L1, 2 16-byte rows with q in registers (D <= 512); + 3
// when the list takes rounds (M > 128).
__host__ inline int descent_variant(int D, int M, int vec) {
  return (vec ? (qreg_of(D, vec) ? 2 : 1) : 0) + (M > 128 ? 3 : 0);
}

template <typename T, bool ROUNDS>
const void* descent_instance(int v) {
  if (v == 2) return reinterpret_cast<const void*>(greedy_descent_kernel<T, true, true, ROUNDS>);
  if (v == 1) return reinterpret_cast<const void*>(greedy_descent_kernel<T, false, true, ROUNDS>);
  return reinterpret_cast<const void*>(greedy_descent_kernel<T, false, false, ROUNDS>);
}

template <typename T>
const void* descent_kernel_of(int v) {
  return v >= 3 ? descent_instance<T, true>(v - 3)
                : descent_instance<T, false>(v);
}

// Raises a descent instance's dynamic shared-memory limit to the card's
// 227 KB, once a device.
template <typename T>
cudaError_t prepare_descent(int v) {
  static bool done[6][64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && done[v][dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(descent_kernel_of<T>(v),
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemOptIn);
  if (e != cudaSuccess) return e;
  if (dev < 64) done[v][dev] = true;
  return cudaSuccess;
}

template <typename T, bool ROUNDS>
void run_descent(const DescentArgs& a, int v, int B, int threads,
                 size_t smem, cudaStream_t st) {
  if (v == 2) {
    greedy_descent_kernel<T, true, true, ROUNDS><<<B, threads, smem, st>>>(a);
  } else if (v == 1) {
    greedy_descent_kernel<T, false, true, ROUNDS><<<B, threads, smem, st>>>(a);
  } else {
    greedy_descent_kernel<T, false, false, ROUNDS><<<B, threads, smem, st>>>(a);
  }
}

template <typename T>
int launch_descent(const DescentArgs& a, int B, int threads, int vec,
                   void* stream) {
  if (B <= 0 || a.max_level <= 0) return 0;
  const int want = 32 * ((a.M + 3) / 4);
  if (a.M < 1 ||
      threads != (want < kDescentMaxThreads ? want : kDescentMaxThreads) ||
      (a.ring && !vec)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DescentLayout L = descent_layout(a.D, sizeof(T), a.M, a.ring);
  if (L.total > static_cast<size_t>(kSmemOptIn)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int v = descent_variant(a.D, a.M, vec);
  const cudaError_t e = prepare_descent<T>(v);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (v >= 3) {
    run_descent<T, true>(a, v - 3, B, threads, L.total, st);
  } else {
    run_descent<T, false>(a, v, B, threads, L.total, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// vectors [N, D] (f32, bf16 or int8), scales [N] f32 or null, q [B, D]
// f32 (16-byte aligned), ids [B, K] i32 -> out [B, K] f32. l2 = 0 scores
// 1 - <q, x> (cosine, ip), l2 = 1 the squared L2 distance. vec = 1
// promises a row of a whole number of 16 bytes and a 16-byte-aligned
// vectors pointer. threads and blocks (B ceil(K / 4) warps in all) are
// the plan of ops._gather_plan. Each returns the launch's cudaError_t (0
// on success).
#define GATHER_DISTANCE_ENTRY(NAME, T)                                       \
  extern "C" int NAME(const void* vectors, const void* scales,              \
                      const void* q, const void* ids, void* out, int B,     \
                      int K, int D, int N, int l2, int vec, int threads,    \
                      int blocks, void* stream) {                           \
    if (B <= 0 || K <= 0) return 0;                                         \
    if (threads < 32 || threads > kHopMaxThreads || threads % 32 ||         \
        static_cast<long long>(blocks) * (threads / 32) <                   \
            static_cast<long long>(B) * ((K + 3) / 4)) {                    \
      return static_cast<int>(cudaErrorInvalidValue);                       \
    }                                                                       \
    HopArgs a;                                                              \
    a.vectors = vectors;                                                    \
    a.scales = static_cast<const float*>(scales);                           \
    a.q = static_cast<const float*>(q);                                     \
    a.ids = static_cast<const int32_t*>(ids);                               \
    a.out = static_cast<float*>(out);                                       \
    a.B = B; a.K = K; a.D = D; a.N = N; a.l2 = l2;                          \
    return launch_hop<T>(a, threads, blocks, vec, stream);                  \
  }

GATHER_DISTANCE_ENTRY(gather_distance_f32, float)
GATHER_DISTANCE_ENTRY(gather_distance_bf16, __nv_bfloat16)
GATHER_DISTANCE_ENTRY(gather_distance_int8, int8_t)

// vectors [N, D], scales [N] f32 or null, upper [L, N, M] i32 (-1 pad),
// q [B, D] f32 (16-byte aligned), ep_in [B] i32, epd_in [B] f32 ->
// ep_out [B] i32, epd_out [B] f32 after the greedy descent of layers
// max_level .. 1 (max_level <= L). threads = min(1024, 32 * ceil(M / 4));
// ring = 1 stages each hop's rows in shared memory (vec rows only), as
// the plan of ops._descent_plan says.
#define GREEDY_DESCENT_ENTRY(NAME, T)                                        \
  extern "C" int NAME(const void* vectors, const void* scales,              \
                      const void* upper, const void* q, const void* ep_in,  \
                      const void* epd_in, void* ep_out, void* epd_out,      \
                      int B, int N, int D, int M, int max_level, int l2,    \
                      int vec, int ring, int threads, void* stream) {       \
    DescentArgs a;                                                          \
    a.vectors = vectors;                                                    \
    a.scales = static_cast<const float*>(scales);                           \
    a.upper = static_cast<const int32_t*>(upper);                           \
    a.q = static_cast<const float*>(q);                                     \
    a.ep_in = static_cast<const int32_t*>(ep_in);                           \
    a.epd_in = static_cast<const float*>(epd_in);                           \
    a.ep_out = static_cast<int32_t*>(ep_out);                               \
    a.epd_out = static_cast<float*>(epd_out);                               \
    a.N = N; a.D = D; a.M = M; a.max_level = max_level; a.l2 = l2;          \
    a.ring = ring;                                                          \
    return launch_descent<T>(a, B, threads, vec, stream);                   \
  }

GREEDY_DESCENT_ENTRY(greedy_descent_f32, float)
GREEDY_DESCENT_ENTRY(greedy_descent_bf16, __nv_bfloat16)
GREEDY_DESCENT_ENTRY(greedy_descent_int8, int8_t)

// The descent block's shared-memory bytes for rows of `elem` bytes an
// element (4, 2 or 1), as the kernel lays them out.
extern "C" long long greedy_descent_smem_bytes(int D, int elem, int M,
                                               int ring) {
  return static_cast<long long>(descent_layout(D, elem, M, ring).total);
}
