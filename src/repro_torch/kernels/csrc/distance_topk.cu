// Exact k-NN partials for fp32, bf16 and int8(+scales) rows, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/distance_topk.py
// (distance_topk_pallas / _kernel): score every query of q [B, D] against
// every row of db [N, D], decoded to fp32 in the row load (bf16 widened,
// int8 converted, then multiplied by its per-row scale when a scale table
// is given), and keep each query's k best rows by (distance, row id).
// cosine/ip score 1 - <q, x>; l2 the expanded |q|^2 - 2 <q, x> + |x|^2,
// as the TPU kernel does. The plain version is
// repro_torch/kernels/ref.py:distance_topk_ref.
//
// Layout. The TPU grid ran (query tile x db tile) in order and wrote one
// top-k per db tile. Here block (split s, query tile) owns one contiguous
// range of rows, walks it in tiles of BN rows, and keeps a running top-k
// per query in shared memory, so the partials are [B, splits * k] with
// splits sized by the wrapper to fill the card (a few hundred blocks), not
// N / BN. kernels/ops.py:flat_topk merges them with one stable sort.
//
// Per tile: 32-dim slices of the rows are loaded with 16-byte loads into
// registers one step ahead (the loads of the next slice are in flight
// while this one's FMAs run), then decoded and stored transposed in shared
// memory (stride BN + 1, so the transposed stores and the compute reads
// both avoid bank conflicts), the query slice beside them; each thread
// accumulates a TQ x TN block of (query, row) dot products with fp32 FMAs
// on the CUDA cores — no tensor cores and no TF32, which would move
// distances by ~1e-3 relative. The
// finished [BQ, BN] distance tile goes to shared memory, and one warp per
// query scans it: lanes ballot the entries that beat the query's current
// k-th (d, id), and each is inserted into the sorted list (k <= 256 slots,
// KS per lane) by a warp-wide rank count and shift. Equal distances break
// on the smaller row id, as lax.top_k's lower index first does. Rows at
// or past the range end are never scanned (no padding), so a range with
// fewer than k rows leaves (INF, -1) in its remaining slots.
//
// What bounds it on this card: bytes at small B (each row is read once per
// query tile: 1M x 384 fp32 is 1.5 GB, 0.46 ms at 3.35 TB/s), fp32
// operations at large B (2 B N D flops: 1.47 ms at B 128 against the 67
// TFLOP/s non-tensor rate). B <= 8 takes a tile of 8 queries x 256 rows
// (eight FMAs per staged value), larger B 64 queries x 128 rows with an
// 8 x 4 register block per thread (32 FMAs per four shared loads).
//
// Plain C interface (no PyTorch headers), loaded with ctypes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDK = 32;              // dims staged per step
constexpr float kInf = 3.0e38f;      // == ref.BEAM_INF, the empty-slot distance
constexpr unsigned kFull = 0xffffffffu;

// Rows of T: load 16 raw bytes holding kVec elements (with vec = 0 only
// the first `valid` are read, one by one, the rest are zero), and decode
// them to fp32.
template <typename T>
struct Rows;

template <>
struct Rows<float> {
  static constexpr int kVec = 4;
  __device__ static uint4 load(const float* p, int valid, int vec) {
    if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
    uint32_t w[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) w[t] = t < valid ? __float_as_uint(__ldg(p + t)) : 0u;
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ static void decode(uint4 v, float* x) {
    x[0] = __uint_as_float(v.x); x[1] = __uint_as_float(v.y);
    x[2] = __uint_as_float(v.z); x[3] = __uint_as_float(v.w);
  }
};

template <>
struct Rows<uint16_t> {              // bf16 bits: the top half of an fp32
  static constexpr int kVec = 8;
  __device__ static uint4 load(const uint16_t* p, int valid, int vec) {
    if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      if (t < valid) w[t >> 1] |= static_cast<uint32_t>(__ldg(p + t)) << (16 * (t & 1));
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ static void decode(uint4 v, float* x) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      x[2 * t] = __uint_as_float(w[t] << 16);
      x[2 * t + 1] = __uint_as_float(w[t] & 0xffff0000u);
    }
  }
};

template <>
struct Rows<int8_t> {
  static constexpr int kVec = 16;
  __device__ static uint4 load(const int8_t* p, int valid, int vec) {
    if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    const unsigned char* b = reinterpret_cast<const unsigned char*>(p);
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      if (t < valid) w[t >> 2] |= static_cast<uint32_t>(__ldg(b + t)) << (8 * (t & 3));
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ static void decode(uint4 v, float* x) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      x[t] = static_cast<float>(static_cast<int8_t>(w[t >> 2] >> (8 * (t & 3))));
    }
  }
};

// One thread's share of a step's staged data, held in registers between
// the global loads (issued before the previous step's FMAs, so they are
// in flight meanwhile) and the shared-memory stores: ITER 16-byte row
// vectors with their rows' scales, and QITER query values.
template <typename T, int BQ, int BN>
struct Stage {
  static constexpr int V = Rows<T>::kVec;
  static constexpr int VPR = kDK / V;             // vectors per row slice
  static constexpr int ITER = BN * VPR / kThreads;
  static constexpr int QITER = BQ * kDK / kThreads;
  static_assert(BN * VPR % kThreads == 0 && BQ * kDK % kThreads == 0,
                "a step's vectors must split evenly over the threads");
  uint4 raw[ITER];
  float scale[ITER];
  float qv[QITER];

  // rows [n0, n0 + BN) x dims [d0, d0 + kDK) of db and the query tile's
  // dims [d0, d0 + kDK); rows past row_end, dims past D, queries past B
  // are zero
  __device__ __forceinline__ void load(const T* __restrict__ db,
                                       const float* __restrict__ scales,
                                       const float* __restrict__ q, int n0,
                                       int row_end, int d0, int D, int q0,
                                       int B, int vec) {
#pragma unroll
    for (int it = 0; it < ITER; ++it) {
      const int e = threadIdx.x + it * kThreads;
      const int row = n0 + e / VPR;
      const int gd = d0 + (e % VPR) * V;
      raw[it] = make_uint4(0u, 0u, 0u, 0u);
      scale[it] = 1.f;
      if (row < row_end && gd < D) {
        raw[it] = Rows<T>::load(db + static_cast<size_t>(row) * D + gd,
                                D - gd, vec);
        if (scales != nullptr) scale[it] = __ldg(scales + row);
      }
    }
#pragma unroll
    for (int it = 0; it < QITER; ++it) {
      const int e = threadIdx.x + it * kThreads;
      const int gq = q0 + e / kDK, gd = d0 + e % kDK;
      qv[it] = (gq < B && gd < D) ? __ldg(q + static_cast<size_t>(gq) * D + gd)
                                  : 0.f;
    }
  }

  // decoded (and scaled: x * 1.0 is exact) rows into xs[dim][row] (stride
  // XS), queries into qs[dim][query] (stride QS)
  template <int XS, int QS>
  __device__ __forceinline__ void store(float* xs, float* qs) const {
#pragma unroll
    for (int it = 0; it < ITER; ++it) {
      const int e = threadIdx.x + it * kThreads;
      const int r = e / VPR, dd = (e % VPR) * V;
      float x[V];
      Rows<T>::decode(raw[it], x);
#pragma unroll
      for (int t = 0; t < V; ++t) xs[(dd + t) * XS + r] = x[t] * scale[it];
    }
#pragma unroll
    for (int it = 0; it < QITER; ++it) {
      const int e = threadIdx.x + it * kThreads;
      qs[(e % kDK) * QS + e / kDK] = qv[it];
    }
  }
};

// (d, id) two-key order: does (da, ia) come before (db, ib)?
__device__ __forceinline__ bool before(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// Slot k - 1 of a warp's register list (KS slots per lane, slot s in lane
// s % 32, register s / 32), broadcast to every lane.
template <int KS>
__device__ __forceinline__ void kth(const float* a_d, const int* a_i, int k,
                                    float& td, int& ti) {
  const int jl = (k - 1) >> 5;
  float vd = a_d[0];
  int vi = a_i[0];
#pragma unroll
  for (int j = 1; j < KS; ++j) {
    if (j == jl) { vd = a_d[j]; vi = a_i[j]; }
  }
  td = __shfl_sync(kFull, vd, (k - 1) & 31);
  ti = __shfl_sync(kFull, vi, (k - 1) & 31);
}

// Merge the `count` distances of one query's tile row (row ids n0 + c)
// into its sorted k-slot list in shared memory. Called by a whole warp.
template <int KS>
__device__ __forceinline__ void update_list(const float* dist_row, float* ld,
                                            int* li, int n0, int count, int k,
                                            int lane) {
  float a_d[KS];
  int a_i[KS];
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    a_d[j] = ld[j * 32 + lane];
    a_i[j] = li[j * 32 + lane];
  }
  float td;
  int ti;
  kth<KS>(a_d, a_i, k, td, ti);
  for (int c0 = 0; c0 < count; c0 += 32) {
    const int c = c0 + lane;
    const float d = c < count ? dist_row[c] : kInf;
    const int id = n0 + c;
    unsigned m = __ballot_sync(kFull, c < count && before(d, id, td, ti));
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      const float cd = __shfl_sync(kFull, d, src);
      const int ci = __shfl_sync(kFull, id, src);
      if (!before(cd, ci, td, ti)) continue;      // the list moved on
      int p = 0;                                  // rank of (cd, ci)
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        const bool less = j * 32 + lane < k && before(a_d[j], a_i[j], cd, ci);
        p += __popc(__ballot_sync(kFull, less));
      }
      float pd[KS];                               // slot s - 1's entry
      int pi[KS];
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        pd[j] = __shfl_up_sync(kFull, a_d[j], 1);
        pi[j] = __shfl_up_sync(kFull, a_i[j], 1);
        const float wd = __shfl_sync(kFull, a_d[j > 0 ? j - 1 : 0], 31);
        const int wi = __shfl_sync(kFull, a_i[j > 0 ? j - 1 : 0], 31);
        if (lane == 0 && j > 0) { pd[j] = wd; pi[j] = wi; }
      }
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        const int s = j * 32 + lane;
        if (s == p) {
          a_d[j] = cd; a_i[j] = ci;
        } else if (s > p) {
          a_d[j] = pd[j]; a_i[j] = pi[j];
        }
      }
      kth<KS>(a_d, a_i, k, td, ti);
    }
  }
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    if (j * 32 + lane < k) {
      ld[j * 32 + lane] = a_d[j];
      li[j * 32 + lane] = a_i[j];
    }
  }
}

template <int BQ, int TQ, int TN, int KS>
struct Tile {
  static constexpr int QG = BQ / TQ;           // query groups
  static constexpr int RG = kThreads / QG;     // row groups: a warp's lanes
  static constexpr int BN = RG * TN;           // rows per tile
  static constexpr int XS = BN + 1;            // staged-row stride (floats)
  static constexpr int QS = BQ + 4;            // staged-query stride
  static constexpr int KP = KS * 32;           // list slots per query
  static constexpr int STAGE = kDK * XS + kDK * QS;
  static constexpr int DIST = BQ * XS;
  static constexpr int UNION = STAGE > DIST ? STAGE : DIST;
  static constexpr size_t kSmem = sizeof(float) * (UNION + BQ + 2 * BQ * KP);
  static_assert(RG % 32 == 0, "a warp's lanes must share one query group");
  static_assert(TQ % 4 == 0 && BQ % 4 == 0, "queries load as float4s");
};

template <typename T, int BQ, int TQ, int TN, int KS, bool L2>
__global__ void __launch_bounds__(kThreads)
distance_topk_kernel(const T* __restrict__ db,
                     const float* __restrict__ scales,
                     const float* __restrict__ q, float* __restrict__ out_d,
                     int32_t* __restrict__ out_i, int B, int N, int D, int k,
                     int rows_per_split, int vec) {
  using L = Tile<BQ, TQ, TN, KS>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* xs = smem;                            // [kDK][XS]   } staging,
  float* qs = smem + kDK * L::XS;              // [kDK][QS]   } then the
  float* dist = smem;                          // [BQ][XS]      distance tile
  float* qn = smem + L::UNION;                 // [BQ] |q|^2
  float* ld = qn + BQ;                         // [BQ][KP] list distances
  int* li = reinterpret_cast<int*>(ld + BQ * L::KP);  // [BQ][KP] list ids

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int qg = tid / L::RG;
  const int rg = tid % L::RG;
  const int q0 = blockIdx.y * BQ;
  const int row_begin = blockIdx.x * rows_per_split;
  const int row_end = min(N, row_begin + rows_per_split);

  for (int i = tid; i < BQ * L::KP; i += kThreads) {
    ld[i] = kInf;
    li[i] = -1;
  }
  if (L2) {
    for (int qi = warp; qi < BQ; qi += kWarps) {
      float acc = 0.f;
      if (q0 + qi < B) {
        const float* qr = q + static_cast<size_t>(q0 + qi) * D;
        for (int d = lane; d < D; d += 32) acc = fmaf(qr[d], qr[d], acc);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(kFull, acc, off);
      }
      if (lane == 0) qn[qi] = acc;
    }
  }
  __syncthreads();

  // steps walk the range tile by tile, each tile in kDK-dim slices; the
  // next step's loads are issued before this step's FMAs
  const int slices = (D + kDK - 1) / kDK;
  const int steps = (row_end - row_begin + L::BN - 1) / L::BN * slices;
  Stage<T, BQ, L::BN> st;
  st.load(db, scales, q, row_begin, row_end, 0, D, q0, B, vec);
  float acc[TQ][TN];
  float xn[TN];
  for (int step = 0; step < steps; ++step) {
    const int slice = step % slices;
    const int n0 = row_begin + step / slices * L::BN;
    if (slice == 0) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        xn[j] = 0.f;
#pragma unroll
        for (int i = 0; i < TQ; ++i) acc[i][j] = 0.f;
      }
    }
    __syncthreads();                   // the last step's readers are done
    st.template store<L::XS, L::QS>(xs, qs);
    __syncthreads();
    if (step + 1 < steps) {
      const int nslice = (step + 1) % slices;
      st.load(db, scales, q, row_begin + (step + 1) / slices * L::BN,
              row_end, nslice * kDK, D, q0, B, vec);
    }
#pragma unroll 4
    for (int dd = 0; dd < kDK; ++dd) {
      float qf[TQ], xf[TN];
      const float4* q4 = reinterpret_cast<const float4*>(
          qs + dd * L::QS + qg * TQ);
#pragma unroll
      for (int i = 0; i < TQ / 4; ++i) {
        const float4 v = q4[i];
        qf[4 * i] = v.x; qf[4 * i + 1] = v.y;
        qf[4 * i + 2] = v.z; qf[4 * i + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) xf[j] = xs[dd * L::XS + rg + L::RG * j];
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(qf[i], xf[j], acc[i][j]);
      }
      if (L2) {
#pragma unroll
        for (int j = 0; j < TN; ++j) xn[j] = fmaf(xf[j], xf[j], xn[j]);
      }
    }
    if (slice != slices - 1) continue;
    __syncthreads();                   // the staging area becomes the tile
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      const int qi = qg * TQ + i;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        dist[qi * L::XS + rg + L::RG * j] =
            L2 ? (qn[qi] - 2.f * acc[i][j]) + xn[j] : 1.f - acc[i][j];
      }
    }
    __syncthreads();
    const int count = min(L::BN, row_end - n0);
    for (int qi = warp; qi < BQ && q0 + qi < B; qi += kWarps) {
      update_list<KS>(dist + qi * L::XS, ld + qi * L::KP, li + qi * L::KP,
                      n0, count, k, lane);
    }
  }
  // each warp wrote only its own queries' lists
  const size_t width = static_cast<size_t>(gridDim.x) * k;
  for (int qi = warp; qi < BQ && q0 + qi < B; qi += kWarps) {
    for (int s = lane; s < k; s += 32) {
      const size_t o = static_cast<size_t>(q0 + qi) * width +
                       static_cast<size_t>(blockIdx.x) * k + s;
      out_d[o] = ld[qi * L::KP + s];
      out_i[o] = li[qi * L::KP + s];
    }
  }
}

struct Args {
  const void* db;
  const float* scales;
  const float* q;
  float* out_d;
  int32_t* out_i;
  int B, N, D, k, splits, rows_per_split, vec;
  cudaStream_t stream;
};

template <typename T, int BQ, int TQ, int TN, int KS, bool L2>
int launch(const Args& a) {
  using L = Tile<BQ, TQ, TN, KS>;
  auto kern = distance_topk_kernel<T, BQ, TQ, TN, KS, L2>;
  if (L::kSmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::kSmem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(a.splits, (a.B + BQ - 1) / BQ);
  kern<<<grid, kThreads, L::kSmem, a.stream>>>(
      static_cast<const T*>(a.db), a.scales, a.q, a.out_d, a.out_i, a.B, a.N,
      a.D, a.k, a.rows_per_split, a.vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BQ, int TQ, int TN, bool L2>
int launch_k(const Args& a) {
  if (a.k <= 32) return launch<T, BQ, TQ, TN, 1, L2>(a);
  if (a.k <= 64) return launch<T, BQ, TQ, TN, 2, L2>(a);
  return launch<T, BQ, TQ, TN, 8, L2>(a);
}

template <typename T>
int launch_t(const Args& a, int l2, int small) {
  if (small) {
    return l2 ? launch_k<T, 8, 8, 1, true>(a) : launch_k<T, 8, 8, 1, false>(a);
  }
  return l2 ? launch_k<T, 64, 8, 4, true>(a) : launch_k<T, 64, 8, 4, false>(a);
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// db [N, D] (dtype 0 f32, 1 bf16, 2 int8), scales [N] f32 or null, q [B, D]
// f32 -> partials out_d [B, splits * k] f32, out_i [B, splits * k] i32:
// block (s, query tile) writes its range's k best (d, id) of each query,
// sorted, at columns [s * k, (s + 1) * k). Split s covers rows
// [s * rows_per_split, (s + 1) * rows_per_split), rows_per_split a multiple
// of the tile (256 rows with small = 1, the B <= 8 tile; else 128).
// l2 = 1 scores the expanded squared L2, 0 scores 1 - <q, x>. vec = 1
// promises D * itemsize % 16 == 0 and a 16-byte-aligned db. 1 <= k <= 256.
// Returns the launch's cudaError_t (0 on success).
extern "C" int distance_topk(const void* db, const void* scales,
                             const void* q, void* out_d, void* out_i, int B,
                             int N, int D, int k, int splits,
                             int rows_per_split, int l2, int dtype, int small,
                             int vec, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (k < 1 || k > 256 || splits < 1 || rows_per_split < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{db, static_cast<const float*>(scales),
               static_cast<const float*>(q), static_cast<float*>(out_d),
               static_cast<int32_t*>(out_i), B, N, D, k, splits,
               rows_per_split, vec, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return launch_t<float>(a, l2, small);
    case 1: return launch_t<uint16_t>(a, l2, small);
    case 2: return launch_t<int8_t>(a, l2, small);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
