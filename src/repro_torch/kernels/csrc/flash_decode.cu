// One-token GQA decode attention with an online softmax, for NVIDIA Hopper
// (sm_90a), in one launch: the split over the cache and the merge of its
// partials. q, K and V are fp32, bf16 or fp16 (one type a launch, an
// instance each); every score, exponent, partial and the output are fp32.
//
// Replaces the TPU kernel repro/kernels/flash_decode.py
// (flash_decode_pallas / _kernel): out[b, h] = softmax(q[b, h] . K[b]^T
// * Dh^-0.5, masked at positions >= cur_len[b]) . V[b], with query head h
// reading KV head h / G (G = H / KVH query heads per KV head, the
// q.reshape(b, kvh, g, dh) grouping of the plain version,
// repro_torch/kernels/ref.py:flash_decode_ref). cur_len is clamped to
// [0, S]; a row at 0 gets zeros, as the TPU kernel writes (the plain
// version averages V there; the decode path never passes 0).
//
// What bounds it on this card: bytes. Every live cache position is read
// once (a K and a V row of Dh elements per KV head) for 4 G Dh flops, about
// one flop per byte at G 4 in fp32 (two in bf16): the tensor cores would
// add nothing, so the products run on the CUDA cores and the design keeps
// bytes in flight.
//
// Element types. The ring holds the cache's own type V, so a 2-byte row is
// half the bytes of an fp32 one and the tile and stage count grow to fill
// the same ring. A lane reads four elements at once (a float4, or 8 bytes
// of bf16 / fp16) and widens them to fp32 exactly, as the plain version's
// .float() does; q is widened on load. Everything after the load is the
// fp32 arithmetic of the fp32 instance.
//
// Streams and units. A stream is one (KV head, head group of gb query
// heads) of a row; a unit is a tile of T live positions of one row for
// SB consecutive streams, whose KV heads are adjacent in the cache, so a
// unit's K (and V) rows are T runs of KW * Dh contiguous floats (4 KB for
// llama3-8b: all 8 KV heads). Units of one KV head, whose 512-byte rows
// lie 4 KB apart, held the same ring to about half the rate on the H100.
//
// Work split by live length (stream-K). Units are ordered (b, stream
// block, tile), and only tiles below cur_len[b] exist, so masked capacity
// is neither launched nor read. The grid is one block per SM (the
// wrapper's choice); every block reads cur_len[0:B] itself, builds the
// tile prefix over the rows in shared memory, and takes an equal
// contiguous share of the units (at least kMinTiles), so a long row is cut
// across many SMs and short rows share one. No host sync plans it.
//
// K/V through an asynchronous ring. One producer warp walks the block's
// units and copies each unit's K and V runs (one cp.async.bulk per
// position and tensor, lanes 0-15 the K runs and 16-31 the V runs) into
// a ring stage, completion counted by the stage's "full" mbarrier
// (expect_tx). T is the largest power of two <= 16 for which three
// stages fit in 200 KB, and the ring takes as many stages as fit there,
// up to 16: at llama3-8b's 4 KB fp32 runs, T 8 and three 64 KB stages,
// 192 KB; its 2 KB bf16 runs, T 16 and three 64 KB stages.
// By Little's law the card needs ~25 KB in flight per SM to sustain 3.35
// TB/s at ~1 us of latency; the consumers use a stage in a small part of
// its arrival time, so two stages or more stay in flight. A cache whose
// rows are not a whole number of 16 bytes (Dh % 4 != 0 in fp32, Dh % 8 !=
// 0 in bf16 / fp16) or that is misaligned takes the generic instance: the
// producer copies element by element and its 32 lanes arrive on the
// barrier.
//
// State in registers. Each consumer warp owns one stream of the unit
// (SB of them) and a share of its positions (WP = 8 / SB warps a
// stream, chunks taken round robin); every consumer warp waits on every
// stage's full barrier and arrives on its "empty" barrier: no block-wide
// barrier in the position loop. A lane holds q (pre-scaled) and the
// running sum acc of the stream's heads for its dims (4-element columns
// lane, lane + 32, ...), so a K or V row is one coalesced read of 16 (or
// 8) bytes a lane from shared memory. Per chunk of 32 / gb positions the gb x positions
// partial dot products are reduced by a butterfly reduce-scatter (31
// shuffles for 32 sums), the lane holding (position, head) applies the
// mask and the online softmax (running max m, its share of the sum l),
// and the probabilities are shuffled back for p . V. The warp's (m, l,
// acc) stay in registers for as long as its units stay in one segment.
//
// Merge in the same launch. When a warp leaves a row it writes its
// partial (m, l, acc) to scratch (slot (block + segment) * warps + warp,
// a segment being a row's units of one stream block: the blocks touching
// a segment and the segments a block touches form a staircase, so block
// + segment is unique per pair) and takes a ticket on its stream's
// counter; the last of the stream's partials merges them through L2 (out
// = sum_k e^(m_k - M) acc_k / sum_k e^(m_k - M) l_k, M = max m_k) and sets
// the counter back to 0 for the next launch. A stream taken by one warp
// alone is written out directly. Every block derives the count of a
// stream's partials from cur_len alone, so no block waits for another.
//
// Plain C interface (no PyTorch headers), loaded with ctypes.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTile = 16;         // positions of a unit at most
constexpr int kMinTiles = 2;         // units a block takes at least
constexpr int kMaxStages = 16;
constexpr int kRingBytes = 200 * 1024;
constexpr int kHead = 16;            // floats before a partial's acc
constexpr int kMaxGB = 8;            // heads of a stream (m[8], l[8])
constexpr float kNeg = -1e30f;       // the plain version's mask value
constexpr unsigned kFull = 0xffffffffu;

// bf16 and fp16 elements, held as their 16 bits
struct bf16_t { uint16_t bits; };
struct f16_t { uint16_t bits; };

// an element widened to fp32 (exact for all three types)
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(bf16_t x) {
  return __uint_as_float(static_cast<uint32_t>(x.bits) << 16);
}
__device__ __forceinline__ float widen(f16_t x) {
  return __half2float(__ushort_as_half(x.bits));
}
// an element read through the read-only cache
__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ bf16_t ldg(const bf16_t* p) {
  return bf16_t{__ldg(&p->bits)};
}
__device__ __forceinline__ f16_t ldg(const f16_t* p) {
  return f16_t{__ldg(&p->bits)};
}
// four consecutive elements (16 bytes of fp32, or 8 of a 2-byte type, so
// aligned), widened
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16_t* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float4 load4(const f16_t* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 hi = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// bytes of a ring of `elems` elements of V, rounded up to 16 (the
// barriers follow it)
template <typename V>
__host__ __device__ inline size_t ring_bytes(size_t elems) {
  return (elems * sizeof(V) + 15) / 16 * 16;
}

template <typename V>
struct Args {
  const V* q;                        // [B, H, Dh]
  const V* k;                        // [B, S, KVH, Dh]
  const V* v;
  const int32_t* cur_len;            // [B]
  float* out;                        // [B, H, Dh]
  float* part;                       // [(grid + segments) * warps][kHead + gb Dh]
  int32_t* tickets;                  // [B * KVH * NG streams], zero between launches
  int B, H, S, KVH, Dh, G, NG;
  int T;                             // positions of a unit
  int SB;                            // streams of a unit
  int KW;                            // KV heads a unit reads
  int WP;                            // warps of a stream
  int stages;
  float scale;
};

// ---------------------------------------------------------------------------
// mbarrier and bulk-copy primitives
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// Wait for the phase of the given parity to complete. A wait that never
// completes (a fault in the pipeline's bookkeeping) traps after ~2^26
// tries, seconds, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (tries == (1u << 26)) __trap();
  }
}
// bytes (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory, counted on bar's transaction count
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
               "::bytes [%0], [%1], %2, [%3];\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes),
                  "r"(smem_u32(bar)) : "memory");
}

// ---------------------------------------------------------------------------
// the unit space: tiles of T live positions, ordered (b, stream block,
// tile); a segment is one row's units of one stream block
// ---------------------------------------------------------------------------
struct Plan {
  const int* pre;                    // [B + 1] tile prefix over rows (smem)
  int SBN;                           // stream blocks a row
  long long U;                       // units
  int n;                             // blocks that take units

  __device__ int tiles(int b) const { return pre[b + 1] - pre[b]; }
  __device__ long long share(int i) const {
    return static_cast<long long>(i) * U / n;
  }
  __device__ long long segment_begin(int seg) const {
    const int b = seg / SBN, sb = seg - b * SBN;
    return static_cast<long long>(SBN) * pre[b] +
           static_cast<long long>(sb) * tiles(b);
  }
  // the blocks whose shares meet units [g0, g1)
  __device__ int first_block(long long g0) const {
    return static_cast<int>(((g0 + 1) * n - 1) / U);
  }
  __device__ int last_block(long long g1) const {
    return static_cast<int>((g1 * n - 1) / U);
  }
};

// A walk over the units: row b, stream block sb, tile of the segment.
struct Cursor {
  int b, sb, tile, tiles;

  __device__ void seek(const Plan& pl, long long u) {
    b = 0;
    while (static_cast<long long>(pl.SBN) * pl.pre[b + 1] <= u) ++b;
    tiles = pl.tiles(b);
    const long long off = u - static_cast<long long>(pl.SBN) * pl.pre[b];
    sb = static_cast<int>(off / tiles);
    tile = static_cast<int>(off - static_cast<long long>(sb) * tiles);
  }
  // to the next unit (which must exist)
  __device__ void next(const Plan& pl) {
    if (++tile < tiles) return;
    tile = 0;
    if (++sb < pl.SBN && tiles > 0) return;
    sb = 0;
    for (++b; (tiles = pl.tiles(b)) == 0; ++b) {}
  }
  __device__ int segment(const Plan& pl) const { return b * pl.SBN + sb; }
};

// ---------------------------------------------------------------------------
// a lane's dims: NC columns of W elements, column c at (c * 32 + lane) * W,
// widened to fp32
// ---------------------------------------------------------------------------
template <int NC, int W, typename V>
__device__ __forceinline__ void load_dims(const V* row, int lane, int Dh,
                                          bool live, float (&x)[NC * W]) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int d = (c * 32 + lane) * W;
    if constexpr (W == 4) {
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (live && d < Dh) f = load4(row + d);
      x[c * 4] = f.x; x[c * 4 + 1] = f.y; x[c * 4 + 2] = f.z; x[c * 4 + 3] = f.w;
    } else {
      x[c] = (live && d < Dh) ? widen(row[d]) : 0.f;
    }
  }
}
// fp32 partials from global memory written by other blocks (through L2)
template <int NC, int W>
__device__ __forceinline__ void load_dims_cg(const float* row, int lane,
                                             int Dh, float (&x)[NC * W]) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int d = (c * 32 + lane) * W;
    if constexpr (W == 4) {
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (d < Dh) f = __ldcg(reinterpret_cast<const float4*>(row + d));
      x[c * 4] = f.x; x[c * 4 + 1] = f.y; x[c * 4 + 2] = f.z; x[c * 4 + 3] = f.w;
    } else {
      x[c] = d < Dh ? __ldcg(row + d) : 0.f;
    }
  }
}
template <int NC, int W>
__device__ __forceinline__ void store_dims(float* row, int lane, int Dh,
                                           const float (&x)[NC * W],
                                           float mul) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int d = (c * 32 + lane) * W;
    if (d >= Dh) continue;
    if constexpr (W == 4) {
      *reinterpret_cast<float4*>(row + d) =
          make_float4(x[c * 4] * mul, x[c * 4 + 1] * mul, x[c * 4 + 2] * mul,
                      x[c * 4 + 3] * mul);
    } else {
      row[d] = x[c] * mul;
    }
  }
}

// The sum over the warp of P partial sums a lane holds (P a power of two
// <= 32): a butterfly reduce-scatter, then an all-reduce across the 32 / P
// lane blocks. Lane l ends with the total of v[l % P].
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

// ---------------------------------------------------------------------------
// the producer warp
// ---------------------------------------------------------------------------
template <int W, typename V>
__device__ void produce(const Args<V>& a, const Plan& pl, const int* lens,
                        long long u0, long long units, V* ring,
                        uint64_t* full, uint64_t* empty, int lane) {
  const size_t pos = static_cast<size_t>(a.KVH) * a.Dh;   // elements a position
  const int run = a.KW * a.Dh;                            // elements a unit row
  const int stage = 2 * a.T * run;
  constexpr uint32_t kElem = sizeof(V);
  Cursor c;
  c.seek(pl, u0);
  for (long long j = 0; j < units; ++j) {
    const int s = static_cast<int>(j % a.stages);
    if (j >= a.stages) {
      mbar_wait(empty + s, static_cast<uint32_t>((j / a.stages - 1) & 1));
    }
    const int t0 = c.tile * a.T;
    const int n = min(a.T, lens[c.b] - t0);
    const size_t off = (static_cast<size_t>(c.b) * a.S + t0) * pos +
                       static_cast<size_t>(c.sb * a.SB / a.NG) * a.Dh;
    V* ks = ring + static_cast<size_t>(s) * stage;
    V* vs = ks + a.T * run;
    if constexpr (W == 4) {
      if (lane == 0) {
        mbar_arrive_tx(full + s, static_cast<uint32_t>(2 * n * run) * kElem);
      }
      __syncwarp();
      const int t = lane & (kMaxTile - 1);
      if (t < n) {
        const bool is_v = lane >= kMaxTile;
        bulk_copy((is_v ? vs : ks) + t * run,
                  (is_v ? a.v : a.k) + off + t * pos,
                  static_cast<uint32_t>(run) * kElem, full + s);
      }
    } else {
      for (int e = lane; e < n * run; e += 32) {
        const int t = e / run, d = e - t * run;
        ks[e] = ldg(a.k + off + t * pos + d);
        vs[e] = ldg(a.v + off + t * pos + d);
      }
      mbar_arrive(full + s);
    }
    if (j + 1 < units) c.next(pl);
  }
}

// ---------------------------------------------------------------------------
// the consumer warps
// ---------------------------------------------------------------------------
template <typename V, int GB, int NC, int W>
struct Warp {
  static constexpr int E = NC * W;                   // floats of a head a lane
  static constexpr int P = kMaxTile * GB < 32 ? kMaxTile * GB : 32;
  static constexpr int TC = P / GB;                  // positions a chunk
  // partials merged at once: their loads in flight together
  static constexpr int MB = GB * E >= 64 ? 1 : 64 / (GB * E);
  float q[GB][E];
  float acc[GB][E];
  float m, l;                        // head lane % GB: running max, sum share

  // heads h0 .. h0 + heads - 1 of row b (the rest of the GB are padding)
  __device__ void start(const Args<V>& a, int b, int h0, int heads,
                        int lane) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      load_dims<NC, W>(a.q + (static_cast<size_t>(b) * a.H + h0 + g) * a.Dh,
                       lane, a.Dh, g < heads, q[g]);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        q[g][e] *= a.scale;
        acc[g][e] = 0.f;
      }
    }
    m = kNeg;
    l = 0.f;
  }

  // positions [c0, c0 + TC) of a stage holding n live rows, K row t at
  // ks + t * rs
  __device__ void chunk(const V* ks, const V* vs, int rs, int c0, int n,
                        int heads, int Dh, int lane) {
    float part[P];
#pragma unroll
    for (int t = 0; t < TC; ++t) {
      float x[E];
      load_dims<NC, W>(ks + (c0 + t) * rs, lane, Dh, c0 + t < n, x);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(q[g][e], x[e], d);
        part[t * GB + g] = d;
      }
    }
    float s = reduce_scatter<P>(part, lane);
    const int vi = lane % P, vt = vi / GB, vg = vi % GB;
    const bool ok = c0 + vt < n && vg < heads;
    s = ok ? s : kNeg;
    float cm = s;
#pragma unroll
    for (int o = GB; o < P; o <<= 1) cm = fmaxf(cm, __shfl_xor_sync(kFull, cm, o));
    const float m_new = fmaxf(m, cm);
    const float alpha = expf(m - m_new);   // 0 on a head's first live chunk
    const float pr = ok ? expf(s - m_new) : 0.f;
    l = l * alpha + pr;
    m = m_new;
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float al = __shfl_sync(kFull, alpha, g);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= al;
    }
#pragma unroll
    for (int t = 0; t < TC; ++t) {
      if (c0 + t >= n) break;
      float x[E];
      load_dims<NC, W>(vs + (c0 + t) * rs, lane, Dh, true, x);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        const float pg = __shfl_sync(kFull, pr, t * GB + g);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(pg, x[e], acc[g][e]);
      }
    }
  }

  // leave segment seg, where this warp took stream (sl of the block, its
  // ps-th warp): write the stream's output, or a partial and take a
  // ticket; the stream's last partial merges them all
  __device__ void flush(const Args<V>& a, const Plan& pl, int seg, int sl,
                        int ps, int lane) {
    const int nw = a.SB * a.WP;
#pragma unroll
    for (int o = GB; o < P; o <<= 1) l += __shfl_xor_sync(kFull, l, o);
    const int b = seg / pl.SBN, str = (seg - b * pl.SBN) * a.SB + sl;
    const int kh = str / a.NG, hg = str - kh * a.NG;
    const int heads = min(GB, a.G - hg * GB);
    const size_t out0 = (static_cast<size_t>(b) * a.H + kh * a.G + hg * GB) *
                        a.Dh;
    const long long g0 = pl.segment_begin(seg);
    const int first = pl.first_block(g0);
    const int count = (pl.last_block(g0 + pl.tiles(b)) - first + 1) * a.WP;
    if (count == 1) {
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        const float lg = __shfl_sync(kFull, l, g);
        if (g < heads) store_dims<NC, W>(a.out + out0 + g * a.Dh, lane, a.Dh,
                                         acc[g], 1.f / lg);
      }
      return;
    }
    const int slot_floats = kHead + GB * a.Dh;
    float* mine = a.part + static_cast<size_t>(
        (blockIdx.x + seg) * nw + sl + a.SB * ps) * slot_floats;
    if (lane < GB) {
      mine[lane] = m;
      mine[kMaxGB + lane] = l;
    }
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      store_dims<NC, W>(mine + kHead + g * a.Dh, lane, a.Dh, acc[g], 1.f);
    }
    __threadfence();
    __syncwarp();
    const int p = b * a.KVH * a.NG + str;
    int last = 0;
    if (lane == 0) last = atomicAdd(a.tickets + p, 1) == count - 1;
    if (!__shfl_sync(kFull, last, 0)) return;
    __threadfence();

    // partial k of the stream: block first + k / WP, its warp
    // sl + SB * (k % WP). The stream's M per head, then
    // sum_k e^(m_k - M) (acc_k, l_k): lane k of a round of 32 finds
    // partial k's slot and weights, which are shuffled to all
    auto slot_of = [&](int k) {
      return (first + k / a.WP + seg) * nw + sl + a.SB * (k % a.WP);
    };
    float mx[GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) mx[g] = kNeg;
    for (int k0 = 0; k0 < count; k0 += 32) {
      if (k0 + lane < count) {
        const float* h =
            a.part + static_cast<size_t>(slot_of(k0 + lane)) * slot_floats;
#pragma unroll
        for (int g = 0; g < GB; ++g) mx[g] = fmaxf(mx[g], __ldcg(h + g));
      }
    }
    float den[GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        mx[g] = fmaxf(mx[g], __shfl_xor_sync(kFull, mx[g], o));
      }
      den[g] = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
    }
    for (int k0 = 0; k0 < count; k0 += 32) {
      int sk = 0;
      float w[GB];
#pragma unroll
      for (int g = 0; g < GB; ++g) w[g] = 0.f;
      if (k0 + lane < count) {
        sk = slot_of(k0 + lane);
        const float* h = a.part + static_cast<size_t>(sk) * slot_floats;
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          w[g] = expf(__ldcg(h + g) - mx[g]);
          den[g] = fmaf(w[g], __ldcg(h + kMaxGB + g), den[g]);
        }
      }
      const int m32 = min(32, count - k0);
      for (int u0 = 0; u0 < m32; u0 += MB) {
        float x[MB][GB][E];
#pragma unroll
        for (int u = 0; u < MB; ++u) {
          const int su = __shfl_sync(kFull, sk, u0 + u);
          const float* src =
              a.part + static_cast<size_t>(su) * slot_floats + kHead;
#pragma unroll
          for (int g = 0; g < GB; ++g) {
            if (u0 + u < m32) {
              load_dims_cg<NC, W>(src + g * a.Dh, lane, a.Dh, x[u][g]);
            } else {
#pragma unroll
              for (int e = 0; e < E; ++e) x[u][g][e] = 0.f;
            }
          }
        }
#pragma unroll
        for (int u = 0; u < MB; ++u) {
#pragma unroll
          for (int g = 0; g < GB; ++g) {
            const float wg = __shfl_sync(kFull, w[g], u0 + u);
#pragma unroll
            for (int e = 0; e < E; ++e) acc[g][e] = fmaf(wg, x[u][g][e], acc[g][e]);
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < GB; ++g) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) den[g] += __shfl_xor_sync(kFull, den[g], o);
      if (g < heads) store_dims<NC, W>(a.out + out0 + g * a.Dh, lane, a.Dh,
                                       acc[g], 1.f / den[g]);
    }
    if (lane == 0) a.tickets[p] = 0;
  }
};

// Consumer warp w takes stream sl = w % SB of every unit of the block's
// share, and of each unit's positions the chunks ps, ps + WP, ...
// (ps = w / SB).
template <typename V, int GB, int NC, int W>
__device__ void consume(const Args<V>& a, const Plan& pl, const int* lens,
                        long long u0, long long units, const V* ring,
                        uint64_t* full, uint64_t* empty, int warp,
                        int lane) {
  constexpr int TC = Warp<V, GB, NC, W>::TC;
  const int sl = warp % a.SB, ps = warp / a.SB;
  const int run = a.KW * a.Dh;
  const int stage = 2 * a.T * run;
  Warp<V, GB, NC, W> st;
  Cursor c;
  c.seek(pl, u0);
  int cur = -1, heads = 0, col = 0;
  for (long long j = 0; j < units; ++j) {
    const int seg = c.segment(pl);
    if (seg != cur) {
      if (cur >= 0) st.flush(a, pl, cur, sl, ps, lane);
      cur = seg;
      const int str = c.sb * a.SB + sl;
      const int kh = str / a.NG, hg = str - kh * a.NG;
      heads = min(GB, a.G - hg * GB);
      col = (kh - c.sb * a.SB / a.NG) * a.Dh;    // the KV head in the run
      st.start(a, c.b, kh * a.G + hg * GB, heads, lane);
    }
    const int s = static_cast<int>(j % a.stages);
    const int n = min(a.T, lens[c.b] - c.tile * a.T);
    mbar_wait(full + s, static_cast<uint32_t>((j / a.stages) & 1));
    const V* ks = ring + static_cast<size_t>(s) * stage + col;
    const V* vs = ks + a.T * run;
#pragma unroll 1
    for (int c0 = ps * TC; c0 < n; c0 += a.WP * TC) {
      st.chunk(ks, vs, run, c0, n, heads, a.Dh, lane);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
    if (j + 1 < units) c.next(pl);
  }
  st.flush(a, pl, cur, sl, ps, lane);
}

template <typename V, int GB, int NC, int W>
__global__ void __launch_bounds__(288, 1)
flash_decode_kernel(const Args<V> a) {
  extern __shared__ float4 smem4[];
  V* ring = reinterpret_cast<V*>(smem4);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<char*>(smem4) +
      ring_bytes<V>(static_cast<size_t>(a.stages) * 2 * a.T * a.KW * a.Dh));
  uint64_t* empty = full + a.stages;
  int* lens = reinterpret_cast<int*>(empty + a.stages);   // [B]
  int* pre = lens + a.B;                                  // [B + 1]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = a.SB * a.WP;                             // consumer warps

  // live lengths and the tile prefix over the rows
  if (warp == 0) {
    int carry = 0;
    for (int b0 = 0; b0 < a.B; b0 += 32) {
      const int b = b0 + lane;
      int t = 0;
      if (b < a.B) {
        const int len = min(max(a.cur_len[b], 0), a.S);
        lens[b] = len;
        t = (len + a.T - 1) / a.T;
      }
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, t, o);
        if (lane >= o) t += y;
      }
      if (b < a.B) pre[b + 1] = carry + t;
      carry += __shfl_sync(kFull, t, 31);
    }
    if (lane == 0) pre[0] = 0;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full + s, W == 4 ? 1 : 32);
      mbar_init(empty + s, nw);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // rows with nothing live get zeros
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    if (lens[b] != 0) continue;
    for (int i = threadIdx.x; i < a.H * a.Dh; i += blockDim.x) {
      a.out[static_cast<size_t>(b) * a.H * a.Dh + i] = 0.f;
    }
  }
  Plan pl;
  pl.pre = pre;
  pl.SBN = a.KVH * a.NG / a.SB;
  pl.U = static_cast<long long>(pl.SBN) * pre[a.B];
  pl.n = static_cast<int>(
      min(static_cast<long long>(gridDim.x), (pl.U + kMinTiles - 1) / kMinTiles));
  if (static_cast<int>(blockIdx.x) >= pl.n) return;
  const long long u0 = pl.share(blockIdx.x);
  const long long units = pl.share(blockIdx.x + 1) - u0;
  if (warp == nw) {
    produce<W>(a, pl, lens, u0, units, ring, full, empty, lane);
  } else {
    consume<V, GB, NC, W>(a, pl, lens, u0, units, ring, full, empty, warp,
                          lane);
  }
}

template <typename V, int GB, int NC, int W>
cudaError_t launch(const Args<V>& a, int grid, int threads, size_t smem,
                   cudaStream_t st) {
  auto kern = flash_decode_kernel<V, GB, NC, W>;
  static bool raised[64] = {};       // the shared-memory limit, per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64 || !raised[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             227 * 1024);
    if (e != cudaSuccess) return e;
    if (dev < 64) raised[dev] = true;
  }
  kern<<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// heads wider than 1,024 floats
// ---------------------------------------------------------------------------
// The stream kernel above keeps a lane's share of gb heads' q and acc in
// registers, which caps Dh at 1,024. A wider head takes this kernel: one
// block of kWideThreads a (b, query head), q (pre-scaled, widened to fp32)
// and acc in shared memory, each thread owning dims tid, tid +
// kWideThreads, ...; per live position one block-wide dot product (warp
// shuffles, then the eight warp sums in order from a double-buffered slot,
// one barrier), the online softmax in every thread alike, and acc = acc *
// alpha + p v. It reads every live K and V row once a query head, G times
// the bytes of the stream kernel; no configuration of the repo has such
// heads, so it is kept simple and right, not fast.
constexpr int kWideThreads = 256;

template <typename V>
struct WideArgs {
  const V* q;                        // [B, H, Dh]
  const V* k;                        // [B, S, KVH, Dh]
  const V* v;
  const int32_t* cur_len;            // [B]
  float* out;                        // [B, H, Dh]
  int H, S, KVH, Dh, G;
  float scale;
};

template <typename V>
__global__ void __launch_bounds__(kWideThreads)
flash_decode_wide_kernel(const WideArgs<V> a) {
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);          // [Dh]
  float* acc = q_s + a.Dh;                               // [Dh]
  float* red = acc + a.Dh;                               // [2][8]
  const int b = blockIdx.x / a.H, h = blockIdx.x - b * a.H;
  const int kh = h / a.G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(max(a.cur_len[b], 0), a.S);
  float* out = a.out + (static_cast<size_t>(b) * a.H + h) * a.Dh;
  if (len == 0) {                    // zeros, as the stream kernel writes
    for (int d = tid; d < a.Dh; d += kWideThreads) out[d] = 0.f;
    return;
  }
  const V* q = a.q + (static_cast<size_t>(b) * a.H + h) * a.Dh;
  for (int d = tid; d < a.Dh; d += kWideThreads) {
    q_s[d] = widen(q[d]) * a.scale;
    acc[d] = 0.f;
  }
  const size_t pos = static_cast<size_t>(a.KVH) * a.Dh;   // elements a position
  const V* k0 = a.k + static_cast<size_t>(b) * a.S * pos +
                static_cast<size_t>(kh) * a.Dh;
  const V* v0 = a.v + static_cast<size_t>(b) * a.S * pos +
                static_cast<size_t>(kh) * a.Dh;
  float m = kNeg, l = 0.f;
  for (int t = 0; t < len; ++t) {
    const V* kr = k0 + t * pos;
    float part = 0.f;
    for (int d = tid; d < a.Dh; d += kWideThreads) {
      part = fmaf(q_s[d], widen(ldg(kr + d)), part);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(kFull, part, o);
    float* slot = red + (t & 1) * 8;
    if (lane == 0) slot[warp] = part;
    __syncthreads();
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWideThreads / 32; ++w) s += slot[w];
    const float m_new = fmaxf(m, s);
    const float alpha = expf(m - m_new);
    const float p = expf(s - m_new);
    l = l * alpha + p;
    m = m_new;
    const V* vr = v0 + t * pos;
    for (int d = tid; d < a.Dh; d += kWideThreads) {
      acc[d] = fmaf(p, widen(ldg(vr + d)), acc[d] * alpha);
    }
  }
  for (int d = tid; d < a.Dh; d += kWideThreads) out[d] = acc[d] / l;
}

__host__ inline size_t wide_smem_bytes(int Dh) {
  return (2 * static_cast<size_t>(Dh) + 16) * sizeof(float);
}

// the stream kernel's launch on elements of V (see flash_decode_f32)
template <typename V>
int run_stream(const void* q, const void* k, const void* v,
               const void* cur_len, void* out, void* part, void* tickets,
               int B, int H, int S, int KVH, int Dh, int gb, int ng, int vec,
               int grid, int warps, float scale, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (KVH <= 0 || H % KVH || Dh <= 0 || Dh > 1024 || warps < 1 ||
      warps > 8 || grid < 1 || (vec && (Dh * sizeof(V)) % 16) ||
      ng * gb < H / KVH || (!vec && gb != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // streams a unit: the most (<= warps) that are whole KV heads (a
  // multiple of ng dividing KVH * ng) or part of one (a divisor of ng)
  int sb = 1;
  for (int d = 1; d <= warps; ++d) {
    if (ng % d == 0 || (d % ng == 0 && KVH % (d / ng) == 0)) sb = d;
  }
  const int kw = sb >= ng ? sb / ng : 1;
  const size_t run = static_cast<size_t>(kw) * Dh * sizeof(V);   // bytes
  const size_t fixed = static_cast<size_t>(2 * B + 1) * sizeof(int) +
                       static_cast<size_t>(2) * kMaxStages * sizeof(uint64_t);
  int T = kMaxTile;
  while (T > 1 && fixed + 3 * 2 * T * run > kRingBytes) T /= 2;
  const size_t stage = 2 * T * run;
  size_t fit = (kRingBytes > fixed ? (kRingBytes - fixed) : 0) / stage;
  if (fit < 1) fit = 1;
  const int stages = static_cast<int>(fit < kMaxStages ? fit : kMaxStages);
  const size_t smem =
      ring_bytes<V>(static_cast<size_t>(stages) * stage / sizeof(V)) +
      2 * stages * sizeof(uint64_t) +
      static_cast<size_t>(2 * B + 1) * sizeof(int);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  Args<V> a;
  a.q = static_cast<const V*>(q);
  a.k = static_cast<const V*>(k);
  a.v = static_cast<const V*>(v);
  a.cur_len = static_cast<const int32_t*>(cur_len);
  a.out = static_cast<float*>(out);
  a.part = static_cast<float*>(part);
  a.tickets = static_cast<int32_t*>(tickets);
  a.B = B; a.H = H; a.S = S; a.KVH = KVH; a.Dh = Dh; a.G = H / KVH;
  a.NG = ng; a.T = T; a.SB = sb; a.KW = kw; a.WP = warps / sb;
  a.stages = stages; a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = (sb * a.WP + 1) * 32;
  const int cols = vec ? (Dh + 127) / 128 : (Dh + 31) / 32;  // lane columns
  cudaError_t e = cudaErrorInvalidValue;
  if (vec) {
    const int nc = cols <= 1 ? 1 : cols <= 2 ? 2 : cols <= 4 ? 4 : 8;
    switch (gb * 16 + nc) {
      case 1 * 16 + 1: e = launch<V, 1, 1, 4>(a, grid, threads, smem, st); break;
      case 2 * 16 + 1: e = launch<V, 2, 1, 4>(a, grid, threads, smem, st); break;
      case 4 * 16 + 1: e = launch<V, 4, 1, 4>(a, grid, threads, smem, st); break;
      case 8 * 16 + 1: e = launch<V, 8, 1, 4>(a, grid, threads, smem, st); break;
      case 1 * 16 + 2: e = launch<V, 1, 2, 4>(a, grid, threads, smem, st); break;
      case 2 * 16 + 2: e = launch<V, 2, 2, 4>(a, grid, threads, smem, st); break;
      case 4 * 16 + 2: e = launch<V, 4, 2, 4>(a, grid, threads, smem, st); break;
      case 1 * 16 + 4: e = launch<V, 1, 4, 4>(a, grid, threads, smem, st); break;
      case 2 * 16 + 4: e = launch<V, 2, 4, 4>(a, grid, threads, smem, st); break;
      case 1 * 16 + 8: e = launch<V, 1, 8, 4>(a, grid, threads, smem, st); break;
      default: break;
    }
  } else {
    const int nc = cols <= 1 ? 1 : cols <= 2 ? 2 : cols <= 4 ? 4
                 : cols <= 8 ? 8 : cols <= 16 ? 16 : 32;
    switch (nc) {
      case 1: e = launch<V, 1, 1, 1>(a, grid, threads, smem, st); break;
      case 2: e = launch<V, 1, 2, 1>(a, grid, threads, smem, st); break;
      case 4: e = launch<V, 1, 4, 1>(a, grid, threads, smem, st); break;
      case 8: e = launch<V, 1, 8, 1>(a, grid, threads, smem, st); break;
      case 16: e = launch<V, 1, 16, 1>(a, grid, threads, smem, st); break;
      case 32: e = launch<V, 1, 32, 1>(a, grid, threads, smem, st); break;
      default: break;
    }
  }
  return static_cast<int>(e);
}

// the wide kernel's launch on elements of V (see flash_decode_wide_f32)
template <typename V>
int run_wide(const void* q, const void* k, const void* v, const void* cur_len,
             void* out, int B, int H, int S, int KVH, int Dh, float scale,
             void* stream) {
  if (B <= 0 || H <= 0) return 0;
  const size_t smem = wide_smem_bytes(Dh);
  if (KVH <= 0 || H % KVH || Dh <= 0 || smem > 227 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kern = flash_decode_wide_kernel<V>;
  static bool raised[64] = {};       // the shared-memory limit, per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64 || !raised[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             227 * 1024);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) raised[dev] = true;
  }
  WideArgs<V> a;
  a.q = static_cast<const V*>(q);
  a.k = static_cast<const V*>(k);
  a.v = static_cast<const V*>(v);
  a.cur_len = static_cast<const int32_t*>(cur_len);
  a.out = static_cast<float*>(out);
  a.H = H; a.S = S; a.KVH = KVH; a.Dh = Dh; a.G = H / KVH;
  a.scale = scale;
  kern<<<B * H, kWideThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q [B, H, Dh], k/v [B, S, KVH, Dh] of one element type (f32, bf16 or f16
// by the entry point), cur_len [B] i32 -> out [B, H, Dh] fp32, all
// contiguous; H % KVH == 0; scale = Dh^-0.5 as the caller rounds it. gb:
// heads of a stream (1, 2, 4 or 8; gb * Dh <= 1024 rounded up to the lane
// columns; 1 when vec is 0), ng = ceil(G / gb) streams a KV head. vec:
// runs read by 16-byte bulk copies (a row a whole number of 16 bytes: Dh %
// 4 == 0 in f32, Dh % 8 == 0 in bf16 / f16; q, k and v 16-byte aligned),
// else element by element (Dh <= 1024). part: the caller's scratch of
// (grid + B * KVH * ng) * warps slots of 16 + gb * Dh floats; tickets: B *
// KVH * ng int32, zero (each launch leaves them zero). grid: blocks (one
// per SM), warps: consumer warps a block at most (1..8). Returns the first
// launch error (0 on success).
#define FLASH_DECODE_ENTRY(SUFFIX, V)                                        \
  extern "C" int flash_decode_##SUFFIX(                                      \
      const void* q, const void* k, const void* v, const void* cur_len,      \
      void* out, void* part, void* tickets, int B, int H, int S, int KVH,    \
      int Dh, int gb, int ng, int vec, int grid, int warps, float scale,     \
      void* stream) {                                                        \
    return run_stream<V>(q, k, v, cur_len, out, part, tickets, B, H, S, KVH, \
                         Dh, gb, ng, vec, grid, warps, scale, stream);       \
  }
FLASH_DECODE_ENTRY(f32, float)
FLASH_DECODE_ENTRY(bf16, bf16_t)
FLASH_DECODE_ENTRY(f16, f16_t)

// The same function for heads of any width whose q and acc fit a block's
// shared memory (2 Dh + 16 floats <= 227 KB): one block a (b, query
// head), no scratch. Returns the launch error (0 on success).
#define FLASH_DECODE_WIDE_ENTRY(SUFFIX, V)                                   \
  extern "C" int flash_decode_wide_##SUFFIX(                                 \
      const void* q, const void* k, const void* v, const void* cur_len,      \
      void* out, int B, int H, int S, int KVH, int Dh, float scale,          \
      void* stream) {                                                        \
    return run_wide<V>(q, k, v, cur_len, out, B, H, S, KVH, Dh, scale,       \
                       stream);                                              \
  }
FLASH_DECODE_WIDE_ENTRY(f32, float)
FLASH_DECODE_WIDE_ENTRY(bf16, bf16_t)
FLASH_DECODE_WIDE_ENTRY(f16, f16_t)
