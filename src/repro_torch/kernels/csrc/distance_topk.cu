// Exact k-NN for fp32, bf16 and int8(+scales) rows, for NVIDIA Hopper
// (sm_90a), in one launch: the scan and the merge of its partial lists.
//
// Replaces the TPU kernel repro/kernels/distance_topk.py
// (distance_topk_pallas / _kernel) and the lax.top_k merge around it:
// score every query of q [B, D] against every row of db [N, D], decoded to
// fp32 (bf16 widened, int8 converted, then scaled per row when a scale
// table is given), and keep each query's k best rows by (distance, row
// id). cosine/ip score 1 - <q, x>; l2 the expanded |q|^2 - 2 <q, x> +
// |x|^2, as the TPU kernel does. Equal distances break on the smaller row
// id, as lax.top_k's lower index first does. The plain version is
// repro_torch/kernels/ref.py:distance_topk_ref.
//
// One launch. The grid's blocks own contiguous row ranges; each keeps its
// queries' sorted (d, id) lists of k <= 256 slots, writes them as partials,
// and takes a ticket (an atomic counter per query tile). The last block of
// a tile to finish merges the tile's partials into the result and sets the
// counter back to 0 for the next launch. A pass may be given a per-query
// "after" pair (d, id): only rows strictly after it in (d, id) order are
// kept, so kernels/ops.py:topk_in_passes serves any k <= N in ceil(k/256)
// passes that write their columns of the result in place.
//
// B <= 8 (the served flat search): a stream over N x D row bytes at ~2 B
// flops a row element, so bytes bound it (1M x 384: 1.536 GB fp32, 0.46
// ms at 3.35 TB/s). One block per SM at most (16 warps; 8 when k > 64);
// each warp walks its own row groups (8 rows for B <= 4, 4 for B 5..8) in
// 128-dim slices, copied raw by cp.async into a private 8 KB ring of
// shared-memory stages (64-128 KB in flight per SM), with no block-wide
// barrier in the scan. A lane decodes four consecutive dims of each row
// in registers (int8 by a byte permute and one fp32 add, exact; bf16 by a
// shift) and multiplies them with the queries' same four dims on the CUDA
// cores: from shared memory (float4) where the queries fit there beside
// the ring and lists, else (wide D) read through L1, slower at B 8 but at
// any D. A butterfly reduce-scatter over the warp then leaves one
// (row, query) sum per lane, which is tested against
// its query's k-th entry held in a register; the rare entries that beat it
// are inserted into the warp's list in shared memory (a warp-wide rank
// count and shift). Row scales (int8) are loaded a group ahead. At the
// end the block merges its warps' lists.
//
// B > 8 (the recall oracle at batch): 2 B N D operations at 64-query
// tiles, bound by arithmetic. A tile of 64 queries x 128 rows per block
// of one warpgroup, two blocks per SM in one wave; query tiles are the
// grid's fastest dimension, so the blocks that read a row range run
// together and its second read hits L2. Each 32-dim slice of the rows
// (raw) and queries is copied by cp.async into one of two stages while the
// other is used; a conversion pass writes the rows' TF32 operands in the
// layout wgmma reads, and the products run on the tensor cores as wgmma
// m64n128k8 TF32 with fp32 accumulation, error-compensated: each fp32
// operand splits into hi (x rounded to TF32) and lo = x - hi, and q_lo
// x_hi + q_hi x_lo + q_hi x_hi stands for q x (the dropped q_lo x_lo and
// the truncation of lo are below 2^-21 relative, where plain TF32 would
// move distances by ~1e-3). bf16 and int8 rows are exact in TF32 (lo =
// 0): two products. int8 rows stay integer in the products and the row
// scale multiplies the finished dot product (and |x|^2 by its square):
// the sum of exact integer-weighted terms is as accurate as the scaled
// one, within 1e-5 of the plain version's decode-then-multiply, and
// exactly equal at scale 1.0. |x|^2 stays an fp32 CUDA-core sum.
// Integer-valued rows and queries make every product and partial sum
// exact, so ids and distances equal the plain version's bit for bit. The
// finished distance tile is tested against each query's k-th entry; the
// queries it beats merge it into their lists, one warp a query. Bound at
// B 128, 1M x 384: 3 x 98.3 GFLOP over 495 TFLOP/s = 0.596 ms (fp32
// rows), 2 x = 0.397 ms (bf16, int8). What holds it above that is the
// slice pipeline, not the products: one slice in flight per block (24 KB
// of rows and queries for fp32 rows) while a block converts, multiplies
// and merges in turn.
//
// Plain C interface (no PyTorch headers), loaded with ctypes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDK = 32;              // dims staged per step (B > 8 tile)
constexpr int kSlice = 128;          // dims per streamed slice (B <= 8)
constexpr float kInf = 3.0e38f;      // == ref.BEAM_INF, the empty-slot distance
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const void* db;
  const float* scales;
  const float* q;
  float* out_d;                      // [B, out_ld]: this pass's columns
  int32_t* out_i;
  int out_ld;
  const float* after_d;              // [B] (stride after_ld) or null
  const int32_t* after_i;
  int after_ld;
  float* part_d;                     // [B, splits * k] partial lists
  int32_t* part_i;
  int32_t* tickets;                  // [query tiles], zero between launches
  int B, N, D, k, splits, rows_per_split, vec;
};

// (d, id) two-key order: does (da, ia) come before (db, ib)?
__device__ __forceinline__ bool before(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// The pair a pass keeps entries after: the previous pass's last entry, or
// (-inf, -1), which every entry comes after.
__device__ __forceinline__ void after_of(const Args& a, int qi, float& ad,
                                         int& ai) {
  ad = -__int_as_float(0x7f800000);
  ai = -1;
  if (a.after_d != nullptr && qi < a.B) {
    ad = a.after_d[static_cast<size_t>(qi) * a.after_ld];
    ai = a.after_i[static_cast<size_t>(qi) * a.after_ld];
  }
}

// A warp's sorted list of KS * 32 slots in registers: slot s in lane
// s % 32, register s / 32. Empty slots hold (kInf, -1), which no entry
// of a list ever comes before.
template <int KS>
struct WarpList {
  float d[KS];
  int i[KS];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int j = 0; j < KS; ++j) { d[j] = kInf; i[j] = -1; }
  }
  __device__ __forceinline__ void load(const float* ld, const int* li,
                                       int lane) {
#pragma unroll
    for (int j = 0; j < KS; ++j) { d[j] = ld[j * 32 + lane]; i[j] = li[j * 32 + lane]; }
  }
  // the first k slots to ld/li
  __device__ __forceinline__ void store(float* ld, int32_t* li, int k,
                                        int lane) const {
#pragma unroll
    for (int j = 0; j < KS; ++j) {
      if (j * 32 + lane < k) { ld[j * 32 + lane] = d[j]; li[j * 32 + lane] = i[j]; }
    }
  }
  // slot k - 1, broadcast to every lane
  __device__ __forceinline__ void kth(int k, float& td, int& ti) const {
    const int jl = (k - 1) >> 5;
    float vd = d[0];
    int vi = i[0];
#pragma unroll
    for (int j = 1; j < KS; ++j) {
      if (j == jl) { vd = d[j]; vi = i[j]; }
    }
    td = __shfl_sync(kFull, vd, (k - 1) & 31);
    ti = __shfl_sync(kFull, vi, (k - 1) & 31);
  }
  // insert (cd, ci), which comes before slot k - 1: rank, then shift the
  // slots after it by one
  __device__ __forceinline__ void insert(float cd, int ci, int k, int lane) {
    int p = 0;
#pragma unroll
    for (int j = 0; j < KS; ++j) {
      const bool less = j * 32 + lane < k && before(d[j], i[j], cd, ci);
      p += __popc(__ballot_sync(kFull, less));
    }
    float pd[KS];
    int pi[KS];
#pragma unroll
    for (int j = 0; j < KS; ++j) {
      pd[j] = __shfl_up_sync(kFull, d[j], 1);
      pi[j] = __shfl_up_sync(kFull, i[j], 1);
      const float wd = __shfl_sync(kFull, d[j > 0 ? j - 1 : 0], 31);
      const int wi = __shfl_sync(kFull, i[j > 0 ? j - 1 : 0], 31);
      if (lane == 0 && j > 0) { pd[j] = wd; pi[j] = wi; }
    }
#pragma unroll
    for (int j = 0; j < KS; ++j) {
      const int s = j * 32 + lane;
      if (s == p) {
        d[j] = cd; i[j] = ci;
      } else if (s > p) {
        d[j] = pd[j]; i[j] = pi[j];
      }
    }
  }
  // offer each lane's (cd, ci) where ok: the ones before slot k - 1 go in
  __device__ __forceinline__ void offer(float cd, int ci, bool ok, int k,
                                        float& td, int& ti, int lane) {
    unsigned m = __ballot_sync(kFull, ok && before(cd, ci, td, ti));
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      const float xd = __shfl_sync(kFull, cd, src);
      const int xi = __shfl_sync(kFull, ci, src);
      if (!before(xd, xi, td, ti)) continue;      // the list moved on
      insert(xd, xi, k, lane);
      kth(k, td, ti);
    }
  }
};

// Merge `count` entries (cd[c], ci[c]) of shared memory into the list.
template <int KS>
__device__ __forceinline__ void merge_array(WarpList<KS>& L,
                                            const float* cd, const int* ci,
                                            int count, int k, int lane) {
  float td;
  int ti;
  L.kth(k, td, ti);
  for (int c0 = 0; c0 < count; c0 += 32) {
    const int c = c0 + lane;
    const bool ok = c < count;
    L.offer(ok ? cd[c] : kInf, ok ? ci[c] : -1, ok, k, td, ti, lane);
  }
}

// Merge share `sh` of `shares` of `count` entries in device memory, written
// by other blocks of this launch (read through L2): chunks of 32 entries
// sh, sh + shares, ..., kPre chunks loaded ahead so that their latencies
// overlap.
template <int KS>
__device__ __forceinline__ void merge_global(WarpList<KS>& L,
                                             const float* cd, const int* ci,
                                             int count, int sh, int shares,
                                             int k, int lane) {
  constexpr int kPre = 8;
  float td;
  int ti;
  L.kth(k, td, ti);
  const int step = 32 * shares;
  for (int c0 = sh * 32 + lane; c0 - lane < count; c0 += kPre * step) {
    float d[kPre];
    int id[kPre];
#pragma unroll
    for (int u = 0; u < kPre; ++u) {
      const int c = c0 + u * step;
      d[u] = c < count ? __ldcg(cd + c) : kInf;
      id[u] = c < count ? __ldcg(ci + c) : -1;
    }
#pragma unroll
    for (int u = 0; u < kPre; ++u) {
      L.offer(d[u], id[u], c0 + u * step < count, k, td, ti, lane);
    }
  }
}

// After a block wrote its partial lists (k per query of its query tile,
// at column split * k of part_*): take a ticket; the tile's last block
// merges all `splits` partials of each of its nq queries into the output
// and resets the ticket. With fewer queries than warps, each query's
// partials are cut into shares merged by several warps, whose lists then
// meet in shared memory (sd/si: W * KS * 32 slots, free by now; W the
// block's warps).
template <int KS, int W>
__device__ void finish(const Args& a, int tile, int split, int q0, int nq,
                       int* flag, float* sd, int* si) {
  constexpr int KP = KS * 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    *flag = atomicAdd(a.tickets + tile, 1) == a.splits - 1;
  }
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  const int width = a.splits * a.k;
  const int shares = nq >= W ? 1 : W / nq;
  for (int t = warp; t < nq * shares; t += W) {
    const int qi = t % nq, sh = t / nq;
    const size_t row = static_cast<size_t>(q0 + qi);
    WarpList<KS> L;
    L.clear();
    merge_global<KS>(L, a.part_d + row * width, a.part_i + row * width,
                     width, sh, shares, a.k, lane);
    if (shares == 1) {
      L.store(a.out_d + row * a.out_ld, a.out_i + row * a.out_ld, a.k, lane);
    } else {
      L.store(sd + warp * KP, si + warp * KP, a.k, lane);
    }
  }
  if (shares > 1) {
    __syncthreads();
    if (warp < nq) {                   // warp qi holds share 0 of query qi
      const size_t row = static_cast<size_t>(q0 + warp);
      WarpList<KS> L;
      L.load(sd + warp * KP, si + warp * KP, lane);
      for (int sh = 1; sh < shares; ++sh) {
        merge_array<KS>(L, sd + (sh * nq + warp) * KP,
                        si + (sh * nq + warp) * KP, a.k, a.k, lane);
      }
      L.store(a.out_d + row * a.out_ld, a.out_i + row * a.out_ld, a.k, lane);
    }
  }
  if (threadIdx.x == 0) a.tickets[tile] = 0;
}

// ---------------------------------------------------------------------------
// B <= 8: the streaming path
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four consecutive elements of T at p (aligned to 4 elements), as fp32.
// Four int8 in a word, as fp32: x + 128 as the low byte of 2^23's
// mantissa, (2^23 + x + 128) - (2^23 + 128) is x exactly: one byte permute
// and one add, no I2F (which issues at a quarter of the FMA rate).
__device__ __forceinline__ void int8x4(uint32_t w, float* x) {
  w ^= 0x80808080u;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    x[e] = __uint_as_float(__byte_perm(w, 0x4b00u, 0x5440u | e)) - 8388736.f;
  }
}

// Two bf16 in a word, as fp32 (the top half of each).
__device__ __forceinline__ void bf16x2(uint32_t w, float* x) {
  x[0] = __uint_as_float(w << 16);
  x[1] = __uint_as_float(w & 0xffff0000u);
}

template <typename T>
struct Quad;

template <>
struct Quad<float> {
  __device__ static void get(const float* p, float* x) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
};

template <>
struct Quad<uint16_t> {              // bf16 bits: the top half of an fp32
  __device__ static void get(const uint16_t* p, float* x) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    bf16x2(v.x, x);
    bf16x2(v.y, x + 2);
  }
};

template <>
struct Quad<int8_t> {
  __device__ static void get(const int8_t* p, float* x) {
    int8x4(*reinterpret_cast<const uint32_t*>(p), x);
  }
};

// The sum over the warp of P partial sums a lane holds (P a power of two
// <= 32): a butterfly reduce-scatter (step O keeps the half of v whose
// index bit O matches the lane's and adds the partner's other half), then
// an all-reduce across the 32 / P lane blocks. Lane l ends with the total
// of v[l % P].
template <int O, int P>
struct ReduceScatter {
  __device__ __forceinline__ static void step(float (&v)[P], int lane) {
    const bool up = lane & O;
#pragma unroll
    for (int i = 0; i < O; ++i) {
      const float send = up ? v[i] : v[i + O];
      const float keep = up ? v[i + O] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, O);
    }
    ReduceScatter<O / 2, P>::step(v, lane);
  }
};
template <int P>
struct ReduceScatter<0, P> {
  __device__ __forceinline__ static void step(float (&)[P], int) {}
};

template <int P>
__device__ __forceinline__ float reduce_scatter(float (&v)[P], int lane) {
  ReduceScatter<P / 2, P>::step(v, lane);
  float s = v[0];
#pragma unroll
  for (int o = P; o < 32; o <<= 1) s += __shfl_xor_sync(kFull, s, o);
  return s;
}

// Insert (cd, ci) into a sorted list of k slots in shared memory, where it
// comes before slot k - 1. Called by a whole warp.
template <int KS>
__device__ __forceinline__ void smem_insert(float* ld, int* li, float cd,
                                            int ci, int k, int lane) {
  int p = 0;
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    const int s = j * 32 + lane;
    p += __popc(__ballot_sync(kFull, s < k && before(ld[s], li[s], cd, ci)));
  }
  float od[KS];
  int oi[KS];
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    const int s = j * 32 + lane;
    od[j] = s >= 1 && s < k ? ld[s - 1] : kInf;
    oi[j] = s >= 1 && s < k ? li[s - 1] : -1;
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    const int s = j * 32 + lane;
    if (s < k && s >= p) {
      ld[s] = s == p ? cd : od[j];
      li[s] = s == p ? ci : oi[j];
    }
  }
  __syncwarp();
}

template <typename T, int BQ, int KS>
struct Stream {
  static constexpr int W = KS == 8 ? 8 : 16;          // warps a block
  static constexpr int RG = BQ == 8 ? 4 : 8;          // rows per group
  static constexpr int P = RG * BQ;                   // sums per lane
  static constexpr int ROW_BYTES = kSlice * sizeof(T);
  static constexpr int STAGE = RG * ROW_BYTES;        // bytes a stage
  static constexpr int RING = 8192;                   // bytes a warp
  static constexpr int S0 = RING / STAGE;
  static constexpr int S = S0 < 2 ? 2 : (S0 > 16 ? 16 : S0);
  static constexpr int KP = KS * 32;
  static constexpr int E16 = 16 / sizeof(T);          // elements a copy
  static constexpr int CPR = kSlice / E16;            // copies a row slice
  static constexpr int CPL = RG * CPR / 32;           // copies a lane
  static_assert(P <= 32 && RG * CPR % 32 == 0, "a group must fit the warp");
  // shared memory: ring, then lists, then |q|^2 (kSmem), then, where
  // they fit (QS), the queries zero-padded to whole slices
  static constexpr size_t kSmem =
      (static_cast<size_t>(W) * S * STAGE + static_cast<size_t>(W) * BQ * KP * 8 +
       BQ * 4 + 16 + 15) / 16 * 16;
  static size_t smem_qs(int dp) {
    return kSmem + static_cast<size_t>(BQ) * dp * 4;
  }
};

// Dims [d, d + 4) of queries b < BQ as fp32, read through L1 (the
// queries do not fit shared memory): float4 loads when qvec (D % 4 == 0,
// q 16-byte aligned), else scalar loads; zero past D and for b >= nq.
template <int BQ>
__device__ __forceinline__ void query_quad(const Args& a, int d, int nq,
                                           bool qvec, float (&qv)[BQ][4]) {
#pragma unroll
  for (int b = 0; b < BQ; ++b) {
    const float* p = a.q + static_cast<size_t>(b) * a.D + d;
    if (qvec && b < nq && d < a.D) {
      const float4 w = __ldg(reinterpret_cast<const float4*>(p));
      qv[b][0] = w.x; qv[b][1] = w.y; qv[b][2] = w.z; qv[b][3] = w.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        qv[b][e] = (b < nq && d + e < a.D) ? __ldg(p + e) : 0.f;
      }
    }
  }
}

// Copy one work item of a warp (group rows [row0, row0 + RG), dims
// [d0, d0 + kSlice)) into a ring stage, rows past row_end and dims past D
// zero. vec: 16-byte copies by cp.async (rows a whole number of 16 bytes,
// base aligned), copy j of the lane at row cr[j], element cd[j] of the
// slice; else element loads.
template <typename T, int BQ, int KS>
__device__ __forceinline__ void stage_item(const Args& a, unsigned char* st,
                                           int row0, int row_end, int d0,
                                           const int (&cr)[Stream<T, BQ, KS>::CPL],
                                           const int (&cd)[Stream<T, BQ, KS>::CPL],
                                           int lane) {
  using C = Stream<T, BQ, KS>;
  const T* db = static_cast<const T*>(a.db);
  if (a.vec) {
    const T* base = db + static_cast<size_t>(row0) * a.D + d0;
#pragma unroll
    for (int j = 0; j < C::CPL; ++j) {
      const bool ok = row0 + cr[j] < row_end && d0 + cd[j] < a.D;
      const T* src = ok ? base + cr[j] * a.D + cd[j] : db;
      cp_async16(st + (lane + 32 * j) * 16, src, ok ? 16 : 0);
    }
  } else {
    T* dst = reinterpret_cast<T*>(st);
    for (int e = lane; e < C::RG * kSlice; e += 32) {
      const int r = e / kSlice, gd = d0 + e % kSlice;
      const int row = row0 + r;
      dst[e] = (row < row_end && gd < a.D)
                   ? db[static_cast<size_t>(row) * a.D + gd] : T(0);
    }
  }
}

template <typename T, int BQ, int KS, bool L2, bool QS>
__global__ void __launch_bounds__(Stream<T, BQ, KS>::W * 32, 1)
distance_topk_stream(const Args a) {
  using C = Stream<T, BQ, KS>;
  constexpr int W = C::W, RG = C::RG, P = C::P, S = C::S, KP = C::KP;
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nsl = (a.D + kSlice - 1) / kSlice;
  const int dp = nsl * kSlice;
  unsigned char* ring = smem + static_cast<size_t>(warp) * S * C::STAGE;
  float* lists_d = reinterpret_cast<float*>(
      smem + static_cast<size_t>(W) * S * C::STAGE);
  int* lists_i = reinterpret_cast<int*>(lists_d + W * BQ * KP);
  float* qn = reinterpret_cast<float*>(lists_i + W * BQ * KP);
  int* flag = reinterpret_cast<int*>(qn + BQ);
  float* qs = reinterpret_cast<float*>(smem + C::kSmem);  // [BQ][dp] if QS

  const int row_begin = blockIdx.x * a.rows_per_split;
  const int row_end = min(a.N, row_begin + a.rows_per_split);
  const int nq = min(BQ, a.B);
  const bool qvec = (a.D & 3) == 0 &&
                    (reinterpret_cast<uintptr_t>(a.q) & 15) == 0;

  for (int e = threadIdx.x; e < W * BQ * KP; e += W * 32) {
    lists_d[e] = kInf;
    lists_i[e] = -1;
  }
  if constexpr (QS) {
    for (int e = threadIdx.x; e < BQ * dp; e += W * 32) {
      const int b = e / dp, d = e % dp;
      qs[e] = (b < nq && d < a.D) ? a.q[static_cast<size_t>(b) * a.D + d] : 0.f;
    }
  }
  if (L2) {
    for (int b = warp; b < BQ; b += W) {
      float acc = 0.f;
      if (b < nq) {
        const float* qr = a.q + static_cast<size_t>(b) * a.D;
        for (int d = lane; d < a.D; d += 32) acc = fmaf(qr[d], qr[d], acc);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
      if (lane == 0) qn[b] = acc;
    }
  }
  __syncthreads();

  // the query of this lane's sum after the reduce-scatter, its list, its
  // after pair and its k-th entry
  const int v = lane % P, vr = v / BQ, vb = v % BQ;
  float* my_d = lists_d + (warp * BQ + vb) * KP;
  int* my_i = lists_i + (warp * BQ + vb) * KP;
  float ad, td = kInf;
  int ai, ti = -1;
  after_of(a, vb, ad, ai);
  const float qnb = L2 ? qn[vb] : 0.f;
  int cr[C::CPL], cd[C::CPL];
#pragma unroll
  for (int j = 0; j < C::CPL; ++j) {
    cr[j] = (lane + 32 * j) / C::CPR;
    cd[j] = (lane + 32 * j) % C::CPR * C::E16;
  }

  // this warp's groups g = warp, warp + W, ... of the range, each in nsl
  // slices: items t = (group, slice), S - 1 of them in flight
  const int groups = (row_end - row_begin + RG - 1) / RG;
  const int my_groups = groups > warp ? (groups - warp + W - 1) / W : 0;
  const int items = my_groups * nsl;
  const int gstep = W * RG;
  int in_row0 = row_begin + warp * RG, in_sl = 0;     // next item to copy
  auto issue = [&](int t) {
    if (t < items) {
      stage_item<T, BQ, KS>(a, ring + (t % S) * C::STAGE, in_row0, row_end,
                            in_sl * kSlice, cr, cd, lane);
      if (++in_sl == nsl) { in_sl = 0; in_row0 += gstep; }
    }
    cp_async_commit();
  };
#pragma unroll 1
  for (int t = 0; t < S - 1; ++t) issue(t);
  // row scales (int8) are loaded one group ahead of their use
  const bool scaled = a.scales != nullptr;
  int row0 = row_begin + warp * RG, sl = 0;
  float sc_next = 1.f;
  if (scaled && row0 + vr < row_end) sc_next = __ldg(a.scales + row0 + vr);
  float acc[P];
  float xn[RG];
#pragma unroll
  for (int i = 0; i < P; ++i) acc[i] = 0.f;
#pragma unroll
  for (int r = 0; r < RG; ++r) xn[r] = 0.f;
#pragma unroll 1
  for (int t = 0; t < items; ++t) {
    issue(t + S - 1);
    cp_async_wait<S - 1>();
    __syncwarp();
    const T* st = reinterpret_cast<const T*>(ring + (t % S) * C::STAGE);
    float qv[BQ][4];
    if constexpr (QS) {
#pragma unroll
      for (int b = 0; b < BQ; ++b) {
        const float4 w = *reinterpret_cast<const float4*>(qs + b * dp + sl * kSlice + 4 * lane);
        qv[b][0] = w.x; qv[b][1] = w.y; qv[b][2] = w.z; qv[b][3] = w.w;
      }
    } else {
      query_quad<BQ>(a, sl * kSlice + 4 * lane, nq, qvec, qv);
    }
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      float x[4];
      Quad<T>::get(st + r * kSlice + 4 * lane, x);
#pragma unroll
      for (int b = 0; b < BQ; ++b) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r * BQ + b] = fmaf(qv[b][e], x[e], acc[r * BQ + b]);
      }
      if (L2) {
#pragma unroll
        for (int e = 0; e < 4; ++e) xn[r] = fmaf(x[e], x[e], xn[r]);
      }
    }
    __syncwarp();                      // the stage is free to refill
    if (++sl != nsl) continue;

    // the group's sums: lane l holds (row vr, query vb) for l < P
    sl = 0;
    const float dot = reduce_scatter<P>(acc, lane);
    float xx = 0.f;
    if (L2) xx = __shfl_sync(kFull, reduce_scatter<RG>(xn, lane), vr);
#pragma unroll
    for (int i = 0; i < P; ++i) acc[i] = 0.f;
#pragma unroll
    for (int r = 0; r < RG; ++r) xn[r] = 0.f;
    const int row = row0 + vr;
    const float sc = sc_next;
    row0 += gstep;
    if (scaled && row0 + vr < row_end) sc_next = __ldg(a.scales + row0 + vr);
    const bool ok = lane < P && row < row_end && vb < nq;
    const float s = dot * sc;
    const float dist = L2 ? (qnb - 2.f * s) + xx * (sc * sc) : 1.f - s;
    unsigned m = __ballot_sync(kFull, ok && before(ad, ai, dist, row) &&
                                          before(dist, row, td, ti));
    if (m == 0) continue;
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      const float xd = __shfl_sync(kFull, dist, src);
      const int xi = __shfl_sync(kFull, row, src);
      const int cb = src % BQ;
      float* ld = lists_d + (warp * BQ + cb) * KP;
      int* li = lists_i + (warp * BQ + cb) * KP;
      if (!before(xd, xi, ld[a.k - 1], li[a.k - 1])) continue;
      smem_insert<KS>(ld, li, xd, xi, a.k, lane);
    }
    td = my_d[a.k - 1];
    ti = my_i[a.k - 1];
  }
  cp_async_wait<0>();
  __syncthreads();

  // merge the warps' lists of each query; write the block's partials
  for (int b = warp; b < nq; b += W) {
    WarpList<KS> L;
    L.load(lists_d + b * KP, lists_i + b * KP, lane);
    for (int w = 1; w < W; ++w) {
      merge_array<KS>(L, lists_d + (w * BQ + b) * KP,
                      lists_i + (w * BQ + b) * KP, a.k, a.k, lane);
    }
    const size_t o = static_cast<size_t>(b) * a.splits * a.k +
                     static_cast<size_t>(blockIdx.x) * a.k;
    L.store(a.part_d + o, a.part_i + o, a.k, lane);
  }
  finish<KS, W>(a, 0, blockIdx.x, 0, nq, flag, lists_d, lists_i);
}

// Raise a kernel's dynamic shared memory limit to `bytes` on the current
// device, once per kernel, device and size: `allowed` is the kernel's own
// record (a static of its launcher), so later launches skip the call.
constexpr int kMaxDevices = 64;
template <typename K>
int allow_smem(K kern, size_t bytes, size_t (&allowed)[kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < kMaxDevices && bytes <= allowed[dev]) return 0;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (e == cudaSuccess && dev < kMaxDevices) allowed[dev] = bytes;
  return static_cast<int>(e);
}

// The most dynamic shared memory a block of the current device may have.
int smem_optin(size_t& bytes) {
  static int cached[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int v = dev < kMaxDevices ? cached[dev] : 0;
  if (v == 0) {
    e = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < kMaxDevices) cached[dev] = v;
  }
  bytes = static_cast<size_t>(v);
  return 0;
}

template <typename T, int BQ, int KS, bool L2, bool QS>
int run_stream(const Args& a, size_t bytes, cudaStream_t stream) {
  auto kern = distance_topk_stream<T, BQ, KS, L2, QS>;
  static size_t allowed[kMaxDevices] = {};
  if (const int e = allow_smem(kern, bytes, allowed)) return e;
  kern<<<dim3(a.splits, 1), Stream<T, BQ, KS>::W * 32, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The queries go to shared memory where they fit beside the ring and
// lists (at 227 KB a block: D <= 1024 at B 5..8 and k > 32, 2048 at
// k <= 32, 4224 at B 2..4, 23,168 at B 1), else they are read through L1:
// every D is served.
template <typename T, int BQ, int KS, bool L2>
int launch_stream(const Args& a, cudaStream_t stream) {
  using C = Stream<T, BQ, KS>;
  const int dp = (a.D + kSlice - 1) / kSlice * kSlice;
  size_t optin = 0;
  if (const int e = smem_optin(optin)) return e;
  if (C::smem_qs(dp) <= optin) {
    return run_stream<T, BQ, KS, L2, true>(a, C::smem_qs(dp), stream);
  }
  return run_stream<T, BQ, KS, L2, false>(a, C::kSmem, stream);
}

// ---------------------------------------------------------------------------
// B > 8: the 64-query x 128-row tile
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}

// x as TF32 hi + lo, the error-compensated split of the products below:
// hi is x rounded to TF32's 10 mantissa bits (add half an ulp, clear the
// 13 low bits: integer ops at the full rate, where cvt.rna.tf32 issues at
// a quarter of it), lo = x - hi exactly (|lo| <= 2^-11 |x|), whose low
// bits the tensor core drops (2^-21 |x| at most). An x with 13 zero low
// bits (bf16, small integers) splits into hi = x, lo = 0.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// B > 8: a tile of BQ 64 queries x BN 128 rows per block of one
// warpgroup (four warps). Each 32-dim slice of the tile's rows (raw, as
// stored) and of its queries (fp32) is copied by cp.async into one of two
// stages while the other is used. A conversion pass writes the slice's
// rows as TF32 hi (and, for fp32 rows, lo) in the layout wgmma reads (no
// swizzle: core matrices of 8 rows x 16 bytes; the two 4-dim halves of a
// k-step 128 bytes apart, 8-row groups 256 bytes apart), and each k-step
// of 8 dims is two or three wgmma m64n128k8 with the queries' hi and lo
// fragments in registers.
template <typename T, int KS>
struct Tile {
  static constexpr int W = 4, NT = W * 32;           // warps, threads
  static constexpr int BQ = 64, BN = 128;
  static constexpr int RS = kDK * sizeof(T) + 16;    // raw row bytes
  static constexpr int FS = kDK + 4;                 // query row (floats):
                                                     // fragment loads hit
                                                     // 32 banks
  static constexpr int KSTEP = BN * 8 * 4;           // B bytes a k-step
  static constexpr int BT = kDK / 8 * KSTEP;         // hi or lo, a slice
  static constexpr int DS = BN;                      // distance tile stride
  static constexpr int KP = KS * 32;                 // list slots a query
  static constexpr int STAGE = BN * RS + BQ * FS * 4;
  static_assert(BQ * DS * 4 <= 2 * BT, "the distance tile aliases hi, lo");
  static constexpr size_t kSmem = 2 * STAGE + 2 * BT +
      sizeof(float) * (6 * BQ + BN + 2 * BQ * KP) + 16;
};

// Copy slice `d0` of rows [n0, n0 + BN) and of the tile's queries into a
// stage: rows past row_end, dims past D and queries past B are zero.
template <typename T, int KS>
__device__ __forceinline__ void tile_stage(const Args& a, unsigned char* st,
                                           int n0, int row_end, int d0,
                                           int q0, bool qvec) {
  using L = Tile<T, KS>;
  constexpr int E16 = 16 / sizeof(T);
  constexpr int CPR = kDK / E16;                     // copies a row slice
  const T* db = static_cast<const T*>(a.db);
  if (a.vec) {
#pragma unroll
    for (int c = threadIdx.x; c < L::BN * CPR; c += L::NT) {
      const int r = c / CPR, gd = d0 + (c % CPR) * E16, row = n0 + r;
      const bool ok = row < row_end && gd < a.D;
      cp_async16(st + r * L::RS + (c % CPR) * 16,
                 ok ? db + static_cast<size_t>(row) * a.D + gd : db,
                 ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < L::BN * kDK; e += L::NT) {
      const int r = e / kDK, gd = d0 + e % kDK, row = n0 + r;
      reinterpret_cast<T*>(st + r * L::RS)[e % kDK] =
          (row < row_end && gd < a.D)
              ? db[static_cast<size_t>(row) * a.D + gd] : T(0);
    }
  }
  float* qs = reinterpret_cast<float*>(st + L::BN * L::RS);
  if (qvec) {
#pragma unroll
    for (int c = threadIdx.x; c < L::BQ * kDK / 4; c += L::NT) {
      const int qi = c / (kDK / 4), gd = d0 + (c % (kDK / 4)) * 4;
      const bool ok = q0 + qi < a.B && gd < a.D;
      cp_async16(qs + qi * L::FS + (c % (kDK / 4)) * 4,
                 ok ? a.q + static_cast<size_t>(q0 + qi) * a.D + gd : a.q,
                 ok ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int e = threadIdx.x; e < L::BQ * kDK; e += L::NT) {
      const int qi = e / kDK, gd = d0 + e % kDK;
      const bool ok = q0 + qi < a.B && gd < a.D;
      cp_async4(qs + qi * L::FS + e % kDK,
                ok ? a.q + static_cast<size_t>(q0 + qi) * a.D + gd : a.q,
                ok ? 4 : 0);
    }
  }
}

// Sixteen raw elements of T (16-byte aligned) as fp32.
template <typename T>
__device__ __forceinline__ void load16(const unsigned char* p, float* x) {
  if (sizeof(T) == 4) {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const float4 w = reinterpret_cast<const float4*>(p)[v];
      x[4 * v] = w.x; x[4 * v + 1] = w.y; x[4 * v + 2] = w.z; x[4 * v + 3] = w.w;
    }
  } else if (sizeof(T) == 2) {
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const uint4 w = reinterpret_cast<const uint4*>(p)[v];
      bf16x2(w.x, x + 8 * v); bf16x2(w.y, x + 8 * v + 2);
      bf16x2(w.z, x + 8 * v + 4); bf16x2(w.w, x + 8 * v + 6);
    }
  } else {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    int8x4(w.x, x); int8x4(w.y, x + 4); int8x4(w.z, x + 8); int8x4(w.w, x + 12);
  }
}

// The wgmma descriptor of a K-major TF32 tile at p without swizzle: core
// matrices of 8 rows x 16 bytes, 128 bytes apart along K (the leading
// dimension) and 256 bytes apart along the rows.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((s & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n"
               "wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (the warpgroup's 64 x 128 fp32) += a (16 x 8 TF32 a warp, in
// registers, laid out as mma.sync's A) x the 8 x 128 TF32 tile that desc
// describes, on the tensor cores (asynchronous: fence before, commit and
// wait after).
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <typename T, int KS, bool L2>
__global__ void __launch_bounds__(Tile<T, KS>::NT, 2)
distance_topk_tile(const Args a) {
  using L = Tile<T, KS>;
  constexpr int W = L::W, NT = L::NT, BQ = L::BQ, BN = L::BN, RS = L::RS,
                FS = L::FS, DS = L::DS, KP = L::KP;
  constexpr bool kF32 = sizeof(T) == 4;  // fp32 rows need x_lo; bf16 and
                                         // int8 rows are exact in TF32
  extern __shared__ float4 smem4[];
  unsigned char* stages = reinterpret_cast<unsigned char*>(smem4);
  unsigned char* bhi = stages + 2 * L::STAGE;  // B tiles: hi, lo
  unsigned char* blo = bhi + L::BT;
  float* dist = reinterpret_cast<float*>(bhi);  // [BQ][DS], aliases them
  float* qn = reinterpret_cast<float*>(bhi + 2 * L::BT);  // [BQ] |q|^2
  float* xn = qn + BQ;                         // [BN] |x|^2 (unscaled)
  float* ld = xn + BN;                         // [BQ][KP] list distances
  int* li = reinterpret_cast<int*>(ld + BQ * KP);  // [BQ][KP] list ids
  float* kd = reinterpret_cast<float*>(li + BQ * KP);  // [BQ] k-th entry
  int* ki = reinterpret_cast<int*>(kd + BQ);
  float* afd = reinterpret_cast<float*>(ki + BQ);      // [BQ] after pair
  int* afi = reinterpret_cast<int*>(afd + BQ);
  int* hit = afi + BQ;                 // [BQ] the tile holds an entry that
  int* flag = hit + BQ;                // goes into the query's list

  const int B = a.B, D = a.D, k = a.k;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;      // fragment coordinates
  const int tile = blockIdx.x, split = blockIdx.y;
  const int q0 = tile * BQ;
  const int nq = min(BQ, B - q0);
  const int row_begin = split * a.rows_per_split;
  const int row_end = min(a.N, row_begin + a.rows_per_split);
  const bool qvec = (D & 3) == 0 &&
                    (reinterpret_cast<uintptr_t>(a.q) & 15) == 0;

  for (int i = tid; i < BQ * KP; i += NT) {
    ld[i] = kInf;
    li[i] = -1;
  }
  if (tid < BQ) {
    kd[tid] = kInf;
    ki[tid] = -1;
    after_of(a, q0 + tid, afd[tid], afi[tid]);
    hit[tid] = 0;
  }
  if (L2) {
    for (int qi = warp; qi < BQ; qi += W) {
      float acc = 0.f;
      if (q0 + qi < B) {
        const float* qr = a.q + static_cast<size_t>(q0 + qi) * D;
        for (int d = lane; d < D; d += 32) acc = fmaf(qr[d], qr[d], acc);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(kFull, acc, off);
      }
      if (lane == 0) qn[qi] = acc;
    }
  }

  // steps walk the range tile by tile, each tile in kDK-dim slices; step
  // s + 1 is copied while step s is converted and multiplied
  const int slices = (D + kDK - 1) / kDK;
  const int steps = (row_end - row_begin + BN - 1) / BN * slices;
  tile_stage<T, KS>(a, stages, row_begin, row_end, 0, q0, qvec);
  cp_async_commit();
  float c[64];
  float xp = 0.f;                              // |x|^2 of row tid
  for (int step = 0; step < steps; ++step) {
    const int slice = step % slices;
    const int n0 = row_begin + step / slices * BN;
    cp_async_wait<0>();
    __syncthreads();                   // step's stage is in; step - 1 done
    if (step + 1 < steps) {
      const int ns = step + 1;
      tile_stage<T, KS>(a, stages + (ns & 1) * L::STAGE,
                        row_begin + ns / slices * BN, row_end,
                        ns % slices * kDK, q0, qvec);
    }
    cp_async_commit();
    const unsigned char* raw = stages + (step & 1) * L::STAGE;
    const float* qs = reinterpret_cast<const float*>(raw + BN * RS);
    if (slice == 0) {
      xp = 0.f;
#pragma unroll
      for (int i = 0; i < 64; ++i) c[i] = 0.f;
    }
    {
      // row tid of the slice into the B tiles (4-dim chunk j: k-step
      // j / 2, half j % 2)
      const int r = tid;
      const int rofs = (r >> 3) * 256 + (r & 7) * 16;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float x[16];
        load16<T>(raw + r * RS + h * 16 * sizeof(T), x);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cj = h * 4 + j;
          const int o = (cj >> 1) * L::KSTEP + (cj & 1) * 128 + rofs;
          uint32_t hi[4], lo[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            split_tf32(x[4 * j + e], hi[e], lo[e]);
            if (L2) xp = fmaf(x[4 * j + e], x[4 * j + e], xp);
          }
          *reinterpret_cast<uint4*>(bhi + o) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
          if (kF32) {
            *reinterpret_cast<uint4*>(blo + o) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
          }
        }
      }
    }
    fence_proxy_async();               // the B tiles, to wgmma's reads
    __syncthreads();
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const float* qa = qs + (warp * 16 + g) * FS + ks * 8 + t4;
      split_tf32(qa[0], ah[ks][0], al[ks][0]);
      split_tf32(qa[8 * FS], ah[ks][1], al[ks][1]);
      split_tf32(qa[4], ah[ks][2], al[ks][2]);
      split_tf32(qa[8 * FS + 4], ah[ks][3], al[ks][3]);
    }
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {   // small terms first
      const uint64_t dh = wgmma_desc(bhi + ks * L::KSTEP);
      wgmma_tf32(c, al[ks], dh);
      if (kF32) wgmma_tf32(c, ah[ks], wgmma_desc(blo + ks * L::KSTEP));
      wgmma_tf32(c, ah[ks], dh);
    }
    wgmma_commit_wait();
    if (slice != slices - 1) continue;
    // the finished tile: distances into shared memory over the B tiles
    // (every reader of those and of the last tile's distances passed the
    // barrier below), then the lists
    if (L2) xn[tid] = xp;
    __syncthreads();
    // this thread's two queries: their k-th entries and after pairs
    float tkd[2], tad[2];
    int tki[2], tai[2];
#pragma unroll
    for (int hq = 0; hq < 2; ++hq) {
      const int qi = warp * 16 + g + 8 * hq;
      tkd[hq] = kd[qi]; tki[hq] = ki[qi];
      tad[hq] = afd[qi]; tai[hq] = afi[qi];
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = j * 8 + 2 * t4 + h;
        const int row = n0 + r;
        const float sc = (a.scales != nullptr && row < row_end)
                             ? __ldg(a.scales + row) : 1.f;
        const float xx = L2 ? xn[r] * (sc * sc) : 0.f;
#pragma unroll
        for (int hq = 0; hq < 2; ++hq) {
          const int qi = warp * 16 + g + 8 * hq;
          const float s = c[4 * j + 2 * hq + h] * sc;
          const float d = L2 ? (qn[qi] - 2.f * s) + xx : 1.f - s;
          dist[qi * DS + r] = d;
          if (row < row_end && before(tad[hq], tai[hq], d, row) &&
              before(d, row, tkd[hq], tki[hq])) {
            hit[qi] = 1;
          }
        }
      }
    }
    __syncthreads();
    // only the queries with a hit walk the tile into their lists
    const int count = min(BN, row_end - n0);
    for (int qi = warp; qi < nq; qi += W) {
      if (!hit[qi]) continue;
      WarpList<KS> lq;
      lq.load(ld + qi * KP, li + qi * KP, lane);
      float td;
      int ti;
      lq.kth(k, td, ti);
      const float ad = afd[qi];
      const int ai = afi[qi];
      const float* drow = dist + qi * DS;
      for (int c0 = 0; c0 < count; c0 += 32) {
        const int cc = c0 + lane;
        const float d = cc < count ? drow[cc] : kInf;
        const int id = n0 + cc;
        lq.offer(d, id, cc < count && before(ad, ai, d, id), k, td, ti, lane);
      }
      lq.store(ld + qi * KP, li + qi * KP, k, lane);
      if (lane == 0) {
        kd[qi] = td;
        ki[qi] = ti;
        hit[qi] = 0;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int qi = warp; qi < nq; qi += W) {
    const size_t o = static_cast<size_t>(q0 + qi) * a.splits * k +
                     static_cast<size_t>(split) * k;
    for (int s = lane; s < k; s += 32) {
      a.part_d[o + s] = ld[qi * KP + s];
      a.part_i[o + s] = li[qi * KP + s];
    }
  }
  finish<KS, W>(a, tile, split, q0, nq, flag, ld, li);
}

template <typename T, int KS, bool L2>
int launch_tile(const Args& a, cudaStream_t stream) {
  using L = Tile<T, KS>;
  auto kern = distance_topk_tile<T, KS, L2>;
  static size_t allowed[kMaxDevices] = {};
  if (const int e = allow_smem(kern, L::kSmem, allowed)) return e;
  // query tiles vary fastest, so the blocks reading a row range run
  // together and its second read hits L2
  const dim3 grid((a.B + L::BQ - 1) / L::BQ, a.splits);
  kern<<<grid, L::NT, L::kSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int KS, bool L2>
int launch_ks(const Args& a, int small, cudaStream_t stream) {
  if (!small) return launch_tile<T, KS, L2>(a, stream);
  if (a.B == 1) return launch_stream<T, 1, KS, L2>(a, stream);
  if (a.B <= 4) return launch_stream<T, 4, KS, L2>(a, stream);
  return launch_stream<T, 8, KS, L2>(a, stream);
}

template <typename T>
int launch_t(const Args& a, int l2, int small, cudaStream_t stream) {
  if (a.k <= 32) {
    return l2 ? launch_ks<T, 1, true>(a, small, stream)
              : launch_ks<T, 1, false>(a, small, stream);
  }
  if (a.k <= 64) {
    return l2 ? launch_ks<T, 2, true>(a, small, stream)
              : launch_ks<T, 2, false>(a, small, stream);
  }
  return l2 ? launch_ks<T, 8, true>(a, small, stream)
            : launch_ks<T, 8, false>(a, small, stream);
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// db [N, D] (dtype 0 f32, 1 bf16, 2 int8), scales [N] f32 or null, q [B, D]
// f32 -> out_d/out_i: row b's k best (d, id), ascending, at out_* + b *
// out_ld. after_d/after_i (stride after_ld; or null): keep only entries
// strictly after that per-query pair. part_d/part_i [B, splits * k] are
// scratch; tickets [query tiles] int32 must be zero (each launch leaves
// them zero). Block s covers rows [s * rows_per_split, (s + 1) *
// rows_per_split): small = 1 (B <= 8) takes the streaming path, whose
// rows_per_split is a multiple of its row group (8 rows for B <= 4, else
// 4); small = 0 the 64 x 128 tile (rows_per_split a multiple of 128).
// l2 = 1 scores the expanded squared L2, 0 scores 1 - <q, x>. vec = 1
// promises D * itemsize % 16 == 0 and a 16-byte-aligned db. 1 <= k <=
// 256, and k <= N. Returns the launch's cudaError_t (0 on success).
extern "C" int distance_topk(const void* db, const void* scales,
                             const void* q, void* out_d, void* out_i,
                             int out_ld, const void* after_d,
                             const void* after_i, int after_ld, void* part_d,
                             void* part_i, void* tickets, int B, int N, int D,
                             int k, int splits, int rows_per_split, int l2,
                             int dtype, int small, int vec, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (k < 1 || k > 256 || k > N || splits < 1 || rows_per_split < 1 ||
      (small && B > 8) || (after_d == nullptr) != (after_i == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{db, static_cast<const float*>(scales),
               static_cast<const float*>(q), static_cast<float*>(out_d),
               static_cast<int32_t*>(out_i), out_ld,
               static_cast<const float*>(after_d),
               static_cast<const int32_t*>(after_i), after_ld,
               static_cast<float*>(part_d), static_cast<int32_t*>(part_i),
               static_cast<int32_t*>(tickets), B, N, D, k, splits,
               rows_per_split, vec};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_t<float>(a, l2, small, s);
    case 1: return launch_t<uint16_t>(a, l2, small, s);
    case 2: return launch_t<int8_t>(a, l2, small, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
