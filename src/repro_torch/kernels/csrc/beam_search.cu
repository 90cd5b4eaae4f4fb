// Whole layer-0 HNSW ef-beam search in one launch, fp32, bf16 or
// int8(+scales) rows, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/beam_search.py
// (beam_search_pallas / _kernel). The plain version, with the same
// frontier selection, dedup and merge, is
// repro_torch/kernels/ref.py:beam_search_ref; the CPU mirror of this
// file's dedup and rank merge is tests/test_torch_beam.py.
//
// One thread block runs one query's whole search; its state lives in
// shared memory from the first hop to the last. The beam is efp =
// next_pow2(ef) (distance, id, expanded) slots, ascending by the key
// (d, id); slots past ef are empty (INF, -1). The hop count and early
// exit follow beam_search.py:_call (ref.beam_schedule): T frontier nodes a
// hop, the last hop truncated to the budget; no unexpanded entry ends the
// search. At T 1 the visit order is the one-at-a-time search of
// core/hnsw.py.
//
// What bounds it on this card. A hop reads the T neighbour lists, then
// the rows of every candidate that survives dedup (up to T * 2M random
// rows of D x 4, 2 or 1 bytes), two dependent memory round trips; the
// rows are scored once each, 2 D flops a row. At B 1024 the bytes bound
// it (no reuse across queries: ~1,900 rows a query at ef 64, T 4), and
// the int8 decode's instructions nearly do; at the served B 8 the
// latency of each hop does (one SM a query). Scoring one row a warp at
// a time would put ~16 serial round trips in a hop at T 4; I2F decodes
// int8 at a quarter of the FMA rate; a serial dedup walks efp + c shared
// loads a thread; a bitonic merge takes a barrier a stage (~40 a hop).
// This design:
//   1. frontier: every warp selects the first t_live unexpanded entries
//      itself (ballot + popcount over the beam, read only), so no barrier
//      follows it; warp 0 records the selection as a bit mask for the
//      merge, which sets those entries' expanded bits;
//   2. dedup in parallel, with no barrier: a shared-memory id table a hop
//      (open addressing) already holds the beam's ids; each valid
//      candidate slot claims its id with one atomicCAS and is kept iff
//      the id was not there, so every id outside the beam is kept once:
//      ref.beam_dedup_valid's ids (it keeps the first valid copy; a copy's
//      row and distance are its id's, so which copy is kept is moot). A
//      thread takes two candidate slots; a hop of more than 2 * threads
//      candidates (T * 2M > 1,024 at 512 threads) runs steps 2 and 3 in
//      waves of that many, each wave's kept rows in flight as it goes;
//   3. every kept row in flight at once: kept slots take ring slots (one
//      shared atomic a warp) and issue one cp.async.bulk each for their
//      row into a shared-memory ring, counted on one mbarrier (lane 0 of
//      each warp raises the expected bytes first and arrives after the
//      warp's stores); 16-byte cp.async by each warp for its rows was
//      slower at B 8 on the H100. int8 scales are
//      read as soon as the ids are known. The ring holds a whole hop at
//      the served batch (the wrapper's plan, ops._beam_plan); at large B
//      it is smaller, so that 8 queries stay resident an SM, and a hop
//      with more kept rows than ring rows takes them in chunks. Rows that
//      are not a whole number of 16 bytes, or a misaligned table, are
//      copied element by element;
//   4. distances from shared memory, a warp four rows at a time, with the
//      lane mapping and summation order of row_distance.cuh
//      (gather_distance.cu sums every (query, row) pair in the same
//      order): the four rows' lane sums are reduced by a reduce-scatter
//      that adds the same pairs as the xor tree; q sits in registers for
//      D <= 512; int8 decodes by byte permute (exact, full rate, no I2F)
//      and then multiplies by its scale with __fmul_rn, as the plain
//      version does;
//   5. rank merge: a candidate whose key is past the beam's ef-th entry
//      cannot enter and is dropped; each remaining beam entry and
//      candidate counts the candidates below it (groups of lanes split
//      the count) and a candidate binary-searches the sorted beam, so
//      its rank in the merged list is known and it is written there if
//      below ef, and its id put in the next hop's table. Only the ef best
//      survive a hop, so any exact (d, id) top-ef selection gives the
//      reference's beam (ref.beam_merge).
// Two block barriers and one mbarrier wait a hop when the ring holds the
// hop. Keys are unique: (d, id) with -0 taken as +0, and ids distinct
// after dedup.
//
// Plain C interface (no PyTorch headers), loaded with ctypes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"
#include "row_distance.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMinBlocks = 2;        // 512 x 2 threads: 64 registers each
constexpr int kSlots = 2;            // candidate slots a thread a wave
constexpr float kInf = 3.0e38f;      // == core.hnsw.INF, the empty slot

__host__ __device__ inline int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}
__host__ __device__ inline size_t round16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// Shared-memory layout of a block (byte offsets); ops._beam_layout_bytes
// computes the same total.
struct Layout {
  size_t ring, tab, skey, mbar, q, beam0, beam1, sel, cid, cscale, sdist,
      sid, nodes, total;
  int stride;        // ring bytes a row: D * sizeof(row) rounded up to 16
  int hash_bits;     // id table slots: 2^hash_bits >= 2 (ef + T * 2M)
};

__host__ inline Layout make_layout(int D, int es, int m2, int ef, int T,
                                   int threads, int ring_rows) {
  Layout L;
  const int w = T * m2;
  const int efp = next_pow2(ef);
  const int S = next_pow2(2 * (ef + w));
  L.hash_bits = 0;
  while ((1 << L.hash_bits) < S) ++L.hash_bits;
  L.stride = static_cast<int>(round16(static_cast<size_t>(D) * es));
  size_t off = 0;
  L.ring = off;   off += static_cast<size_t>(ring_rows) * L.stride;
  L.tab = off;    off += static_cast<size_t>(2 * S) * 4;   // two id tables
  L.skey = off;   off += round16(static_cast<size_t>(w) * 8);
  L.mbar = off;   off += 32;          // mbarrier; nk, ns of two hops
  L.q = off;      off += round16(static_cast<size_t>(D) * 4);
  L.beam0 = off;  off += round16(static_cast<size_t>(efp) * 12);
  L.beam1 = off;  off += round16(static_cast<size_t>(efp) * 12);
  L.sel = off;    off += round16(static_cast<size_t>((efp + 31) / 32) * 4);
  L.cid = off;    off += round16(static_cast<size_t>(w) * 4);
  L.cscale = off; off += round16(static_cast<size_t>(w) * 4);
  L.sdist = off;  off += round16(static_cast<size_t>(w) * 4);
  L.sid = off;    off += round16(static_cast<size_t>(w) * 4);
  L.nodes = off;  off += round16(static_cast<size_t>(threads / 32) * T * 4);
  L.total = off;
  return L;
}

struct Args {
  const void* vectors;       // [N, D] row type
  const float* scales;       // [N] or null
  const int32_t* nbrs;       // [N, m2]
  const float* q;            // [B, D]
  const int32_t* ep;         // [B]
  const float* ep_dist;      // [B]
  int32_t* out_ids;          // [B, ef]
  float* out_d;              // [B, ef]
  int N, D, m2, ef, efp, T, budget, hops, l2, vec, ring_rows;
  Layout L;
};

// ---------------------------------------------------------------------------
// keys, the hop's id hash
// ---------------------------------------------------------------------------
// (d, id) as one unsigned 64-bit key whose order is the plain version's
// two-key (d, id) order: d's bits made monotone (-0 taken as +0, as the
// float compare takes them), then the id with its sign bit flipped, so
// the empty slots' id -1 sorts below every real id.
__device__ __forceinline__ uint64_t make_key(float d, int id) {
  uint32_t u = __float_as_uint(__fadd_rn(d, 0.f));
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<uint64_t>(u) << 32) |
         (static_cast<uint32_t>(id) ^ 0x80000000u);
}

__device__ __forceinline__ uint32_t hash_slot(int id, int shift) {
  return (static_cast<uint32_t>(id) * 0x9E3779B1u) >> shift;
}

// Put `id` in the table (open addressing, linear probing, -1 empty):
// true iff this call put it there, false if it was there already.
__device__ __forceinline__ bool hash_claim(int* tab, uint32_t mask, int shift,
                                           int id) {
  for (uint32_t s = hash_slot(id, shift);; s = (s + 1) & mask) {
    const int v = atomicCAS(tab + s, -1, id);
    if (v == -1) return true;
    if (v == id) return false;
  }
}

// Number of the sorted keys of beam[0, n) below `key`.
__device__ __forceinline__ int beam_below(const float* bd, const int* bi,
                                          int n, uint64_t key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (make_key(bd[mid], bi[mid]) < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// VEC: 16-byte rows (a.vec), copied by cp.async.bulk; else element copies.
// QREG (VEC only): q in registers.
template <typename T, bool QREG, bool VEC>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
beam_search_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout& L = a.L;
  unsigned char* ring = smem + L.ring;
  uint64_t* skey = reinterpret_cast<uint64_t*>(smem + L.skey);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.mbar);
  int* counts = reinterpret_cast<int*>(smem + L.mbar + 8);  // nk, ns of 2 hops
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  uint32_t* selm = reinterpret_cast<uint32_t*>(smem + L.sel);
  int* cid = reinterpret_cast<int*>(smem + L.cid);
  float* cscale = reinterpret_cast<float*>(smem + L.cscale);
  float* sdist = reinterpret_cast<float*>(smem + L.sdist);
  int* sid = reinterpret_cast<int*>(smem + L.sid);

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = nthr >> 5;
  const int D = a.D, ef = a.ef, efp = a.efp, m2 = a.m2;
  const int w = a.T * m2;
  const uint32_t hmask = (1u << L.hash_bits) - 1u;
  const int hshift = 32 - L.hash_bits;
  const int S = 1 << L.hash_bits;
  const uint32_t rowb = static_cast<uint32_t>(D * sizeof(T));
  const int nvec = static_cast<int>(rowb / 16);
  const bool scaled = a.scales != nullptr;
  const T* vectors = static_cast<const T*>(a.vectors);
  int* nodes = reinterpret_cast<int*>(smem + L.nodes) + warp * a.T;
  const uint64_t pad_key = make_key(kInf, -1);
  const unsigned lt_mask = (1u << lane) - 1u;

  // two of each, this hop's (k = cur) and the next one's: the beam's
  // buffers (efp distances, ids, expanded flags) and the id tables (the
  // beam's ids, then the hop's kept candidates')
  auto beam_d = [&](int k) {
    return reinterpret_cast<float*>(smem + (k ? L.beam1 : L.beam0));
  };
  auto beam_i = [&](int k) {
    return reinterpret_cast<int*>(smem + (k ? L.beam1 : L.beam0) + efp * 4);
  };
  auto beam_x = [&](int k) {
    return reinterpret_cast<int*>(smem + (k ? L.beam1 : L.beam0) + efp * 8);
  };
  auto table = [&](int k) {
    return reinterpret_cast<int*>(smem + L.tab) + k * S;
  };

  for (int d = tid; d < D; d += nthr) q_s[d] = a.q[static_cast<size_t>(b) * D + d];
  // The entry point is the only live entry. It goes at slot ef - 1 when
  // its key sorts after the empty slots' (a distance >= INF), so that
  // beam[0, ef) is sorted for the merge's binary search; the frontier
  // finds it there all the same. With no hop to run it stays at slot 0,
  // as the plain version returns it. The first hop's table holds its id,
  // in its home slot of the empty table.
  {
    const float e_d = a.ep_dist[b];
    const int e_i = a.ep[b];
    const int epos =
        (a.hops > 0 && e_i >= 0 && make_key(e_d, e_i) > pad_key) ? ef - 1 : 0;
    float* d0 = beam_d(0);
    int* i0 = beam_i(0);
    int* x0 = beam_x(0);
    for (int p = tid; p < efp; p += nthr) {
      d0[p] = p == epos ? e_d : kInf;
      i0[p] = p == epos ? e_i : -1;
      x0[p] = p != epos;
    }
    const int home = e_i >= 0 ? static_cast<int>(hash_slot(e_i, hshift)) : -1;
    int* t0 = table(0);
    for (int i = tid; i < S; i += nthr) t0[i] = i == home ? e_i : -1;
  }
  if (tid == 0) {
    counts[0] = 0;
    counts[1] = 0;
    mbar_init(bar, nw);              // lane 0 of each warp arrives
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float qr[QREG ? kQRegFloats : 1];
  if (QREG) lane_q_regs<T>(q_s, nvec, lane, qr);

  uint32_t parity = 0;
  int cur = 0;
  for (int hop = 0; hop < a.hops; ++hop) {
    const float* cd = beam_d(cur);
    const int* ci = beam_i(cur);
    const int* cx = beam_x(cur);
    float* nd = beam_d(cur ^ 1);
    int* ni = beam_i(cur ^ 1);
    int* nx = beam_x(cur ^ 1);
    int* tab = table(cur);
    int* tnext = table(cur ^ 1);
    int* nk_s = counts + 2 * cur;
    int* ns_s = nk_s + 1;

    // -- 1. frontier: every warp reads the beam and selects the first
    //    t_live unexpanded entries for itself; warp 0 records them
    const int t_live = min(a.T, a.budget - hop * a.T);
    int running = 0;
    for (int base = 0; base < efp; base += 32) {
      const int p = base + lane;
      const bool un = p < efp && cx[p] == 0 && ci[p] >= 0;
      const unsigned m = __ballot_sync(kFull, un);
      const int rank = running + __popc(m & lt_mask);
      const bool sel = un && rank < t_live;
      if (sel) nodes[rank] = ci[p];
      const unsigned sm = __ballot_sync(kFull, sel);
      if (warp == 0 && lane == 0) selm[base >> 5] = sm;
      running += __popc(m);
    }
    if (running == 0) break;   // no frontier left: the search has converged
    for (int j = min(running, t_live) + lane; j < a.T; j += 32) nodes[j] = -1;
    __syncwarp();

    // the next hop's beam, table and counters start empty
    for (int p = tid; p < efp; p += nthr) {
      nd[p] = kInf;
      ni[p] = -1;
      nx[p] = 1;
    }
    for (int i = tid; i < S; i += nthr) tnext[i] = -1;
    if (tid == 0) {
      counts[2 * (cur ^ 1)] = 0;
      counts[2 * (cur ^ 1) + 1] = 0;
    }

    // -- 2. neighbour lists of the frontier (slot c = j * m2 + e), an
    //    int8 slot's scale as soon as its id is known; a hop of more
    //    than kSlots * threads candidates takes them in waves of that
    //    many, each through steps 2 and 3
    for (int w0 = 0; w0 < w; w0 += kSlots * nthr) {
      int cand[kSlots];
      bool ok[kSlots];
      float sc[kSlots];
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int c = w0 + tid + s * nthr;
        int nb = -1;
        if (c < w) {
          const int j = c / m2;
          const int node = nodes[j];
          if (node >= 0) {
            const int row = node >= a.N ? a.N - 1 : node;
            nb = __ldg(a.nbrs + static_cast<size_t>(row) * m2 + (c - j * m2));
          }
        }
        ok[s] = nb >= 0;
        cand[s] = nb < 0 ? 0 : (nb >= a.N ? a.N - 1 : nb);
        sc[s] = scaled && ok[s] ? __ldg(a.scales + cand[s]) : 1.f;
      }

      // -- 3. dedup: a valid slot is kept iff it claims its id in the
      //    table that holds the beam's ids (and the earlier waves'
      //    kept ids), so each id outside the beam is kept once
      //    (ref.beam_dedup_valid keeps the first valid copy: the same
      //    ids, and a copy's row and distance are the copy's id's). Kept
      //    slots take ring slots (one shared atomic a warp) and request
      //    their rows at once.
      int kk[kSlots];
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const bool keep = ok[s] && hash_claim(tab, hmask, hshift, cand[s]);
        const unsigned m = __ballot_sync(kFull, keep);
        int base = 0;
        if (lane == 0 && m) base = atomicAdd(nk_s, __popc(m));
        base = __shfl_sync(kFull, base, 0);
        kk[s] = keep ? base + __popc(m & lt_mask) : -1;
        if (VEC) {
          // the warp's copies: lane 0 raises the phase's bytes first
          const bool copy = keep && kk[s] < a.ring_rows;
          const unsigned mc = __ballot_sync(kFull, copy);
          if (lane == 0 && mc) mbar_expect_tx(bar, __popc(mc) * rowb);
          __syncwarp();
          if (copy) {
            bulk_copy(ring + static_cast<size_t>(kk[s]) * L.stride,
                      vectors + static_cast<size_t>(cand[s]) * D, rowb, bar);
          }
        }
      }
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        if (kk[s] >= 0) {
          cid[kk[s]] = cand[s];
          if (scaled) cscale[kk[s]] = sc[s];
        }
      }
    }
    if (VEC) {
      __syncwarp();                  // the warp's stores, before its arrival
      if (lane == 0) mbar_arrive(bar);
      mbar_wait(bar, parity);
      parity ^= 1u;
    } else {
      __syncthreads();
    }
    const int nk = *nk_s;

    // -- 4. distances, a warp four rows at a time; keep what can enter
    const uint64_t worst = make_key(cd[ef - 1], ci[ef - 1]);
    for (int base = 0; base < nk; base += a.ring_rows) {
      const int cnt = min(a.ring_rows, nk - base);
      if (base > 0) {
        __syncthreads();                 // every warp is done with the ring
        if (VEC) {
          for (int r0 = 0; r0 < cnt; r0 += nthr) {
            const int r = r0 + tid;
            const unsigned mc = __ballot_sync(kFull, r < cnt);
            if (lane == 0 && mc) mbar_expect_tx(bar, __popc(mc) * rowb);
            __syncwarp();
            if (r < cnt) {
              bulk_copy(ring + static_cast<size_t>(r) * L.stride,
                        vectors + static_cast<size_t>(cid[base + r]) * D,
                        rowb, bar);
            }
          }
          if (lane == 0) mbar_arrive(bar);
          mbar_wait(bar, parity);
          parity ^= 1u;
        }
      }
      if (!VEC) {
        T* rt = reinterpret_cast<T*>(ring);
        const int se = L.stride / static_cast<int>(sizeof(T));
        for (int e = tid; e < cnt * D; e += nthr) {
          const int r = e / D;
          const int d = e - r * D;
          rt[r * se + d] = vectors[static_cast<size_t>(cid[base + r]) * D + d];
        }
        __syncthreads();
      }
      for (int r0 = 4 * warp; r0 < cnt; r0 += 4 * nw) {
        float acc[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = r0 + j;
          acc[j] = 0.f;
          if (r < cnt) {
            const float s = scaled ? cscale[base + r] : 1.f;
            const unsigned char* row = ring + static_cast<size_t>(r) * L.stride;
            acc[j] = VEC ? lane_sum_vec<T, QREG>(row, qr, q_s, s, scaled,
                                                 nvec, lane, a.l2)
                         : lane_sum_elem<T>(row, q_s, s, scaled, D, lane,
                                            a.l2);
          }
        }
        const float tot = warp_total4(acc, lane);
        const float dist = a.l2 ? tot : 1.f - tot;
        const int r = r0 + (lane >> 3);
        bool in = false;
        int id = 0;
        uint64_t key = 0;
        if ((lane & 7) == 0 && r < cnt) {
          id = cid[base + r];
          key = make_key(dist, id);
          in = key < worst;            // past the ef-th entry it cannot enter
        }
        const unsigned m = __ballot_sync(kFull, in);
        int sb = 0;
        if (lane == 0 && m) sb = atomicAdd(ns_s, __popc(m));
        sb = __shfl_sync(kFull, sb, 0);
        if (in) {
          const int j = sb + __popc(m & lt_mask);
          skey[j] = key;
          sdist[j] = dist;
          sid[j] = id;
        }
      }
    }
    __syncthreads();

    // -- 5. rank merge into the next beam. Rank = entries below the key:
    //    beam entries (their slot, or a binary search for a candidate),
    //    kept candidates (counted by groups of g lanes), and, for a key
    //    past the empty slots' (INF, -1), the empty slots outside
    //    beam[0, ef): efp - ef beam slots and T * 2M - nk candidate slots.
    //    Candidates dropped above sort after every entry that lands
    //    below ef, so they change no such rank. Each entry placed puts
    //    its id in the next hop's table.
    const int ns = *ns_s;
    const int extra = (efp - ef) + (w - nk);
    const int items = ef + ns;
    int g = 1;
    while (g < 32 && items * 2 * g <= nthr) g <<= 1;
    const int per = nthr / g;
    const int sub = lane & (g - 1);
    for (int base = 0; base < items; base += per) {
      const int it = base + tid / g;
      bool live = false;
      uint64_t key = 0;
      if (it < ef) {
        live = ci[it] >= 0;
        if (live) key = make_key(cd[it], ci[it]);
      } else if (it < items) {
        live = true;
        key = skey[it - ef];
      }
      int less = 0;
      if (live) {
#pragma unroll 4
        for (int c = sub; c < ns; c += g) less += skey[c] < key ? 1 : 0;
      }
      for (int o = 1; o < g; o <<= 1) less += __shfl_xor_sync(kFull, less, o);
      if (live && sub == 0) {
        int rank = less + (key > pad_key ? extra : 0);
        float dd;
        int id, xx;
        if (it < ef) {
          rank += it;
          dd = cd[it];
          id = ci[it];
          xx = cx[it] | static_cast<int>((selm[it >> 5] >> (it & 31)) & 1u);
        } else {
          const int k = it - ef;
          rank += beam_below(cd, ci, ef, key);
          dd = sdist[k];
          id = sid[k];
          xx = 0;
        }
        if (rank < ef) {
          nd[rank] = dd;
          ni[rank] = id;
          nx[rank] = xx;
          hash_claim(tnext, hmask, hshift, id);
        }
      }
    }
    __syncthreads();
    cur ^= 1;
  }

  const float* fd = beam_d(cur);
  const int* fi = beam_i(cur);
  for (int p = tid; p < ef; p += nthr) {
    a.out_ids[static_cast<size_t>(b) * ef + p] = fi[p];
    a.out_d[static_cast<size_t>(b) * ef + p] = fd[p];
  }
}

// The instance a launch takes: 0 element copies, 1 16-byte rows with q
// in shared memory, 2 16-byte rows with q in registers (D <= 512).
__host__ inline int variant_of(int D, int vec) {
  return vec ? (D <= 32 * kQRegFloats ? 2 : 1) : 0;
}

template <typename T>
const void* kernel_of(int v) {
  if (v == 2) return reinterpret_cast<const void*>(beam_search_kernel<T, true, true>);
  if (v == 1) return reinterpret_cast<const void*>(beam_search_kernel<T, false, true>);
  return reinterpret_cast<const void*>(beam_search_kernel<T, false, false>);
}

// Raises the kernel's dynamic shared-memory limit to the card's 227 KB
// and asks for the largest shared-memory carveout, once a device.
template <typename T>
cudaError_t prepare(int v) {
  static bool done[3][64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && done[v][dev]) return cudaSuccess;
  const void* k = kernel_of<T>(v);
  e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           227 * 1024);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  if (dev < 64) done[v][dev] = true;
  return cudaSuccess;
}

template <typename T>
int launch(Args a, int B, int threads, void* stream) {
  if (B <= 0) return 0;
  if (threads < 32 || threads > kMaxThreads || threads % 32 || a.ring_rows < 1 ||
      a.ef < 1 || a.T < 1 || a.D < 1 || a.efp != next_pow2(a.ef)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.L = make_layout(a.D, sizeof(T), a.m2, a.ef, a.T, threads, a.ring_rows);
  if (a.L.total > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int v = variant_of(a.D, a.vec);
  cudaError_t e = prepare<T>(v);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (v == 2) {
    beam_search_kernel<T, true, true><<<B, threads, a.L.total, st>>>(a);
  } else if (v == 1) {
    beam_search_kernel<T, false, true><<<B, threads, a.L.total, st>>>(a);
  } else {
    beam_search_kernel<T, false, false><<<B, threads, a.L.total, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int occupancy(int D, int vec, int threads, size_t smem, int* blocks) {
  const int v = variant_of(D, vec);
  cudaError_t e = prepare<T>(v);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel_of<T>(v), threads, smem));
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
// 16-byte-aligned vectors pointer. threads (a multiple of 32, <= 512;
// a hop's T * m2 candidates go in waves of 2 * threads) and ring_rows
// (>= 1) are the wrapper's plan (ops._beam_plan). Each returns the
// launch's cudaError_t (0 on success).
#define BEAM_SEARCH_ENTRY(NAME, RowT)                                        \
  extern "C" int NAME(const void* vectors, const void* scales,             \
                      const void* nbrs, const void* q, const void* ep,     \
                      const void* ep_dist, void* out_ids, void* out_d,     \
                      int B, int N, int D, int m2, int ef, int efp,        \
                      int T, int budget, int hops, int l2, int vec,        \
                      int threads, int ring_rows, void* stream) {          \
    Args a;                                                                \
    a.vectors = vectors;                                                   \
    a.scales = static_cast<const float*>(scales);                          \
    a.nbrs = static_cast<const int32_t*>(nbrs);                            \
    a.q = static_cast<const float*>(q);                                    \
    a.ep = static_cast<const int32_t*>(ep);                                \
    a.ep_dist = static_cast<const float*>(ep_dist);                        \
    a.out_ids = static_cast<int32_t*>(out_ids);                            \
    a.out_d = static_cast<float*>(out_d);                                  \
    a.N = N; a.D = D; a.m2 = m2; a.ef = ef; a.efp = efp; a.T = T;          \
    a.budget = budget; a.hops = hops; a.l2 = l2; a.vec = vec;              \
    a.ring_rows = ring_rows;                                               \
    return launch<RowT>(a, B, threads, stream);                            \
  }

BEAM_SEARCH_ENTRY(beam_search_f32, float)
BEAM_SEARCH_ENTRY(beam_search_bf16, __nv_bfloat16)
BEAM_SEARCH_ENTRY(beam_search_int8, int8_t)

// The launch's shared-memory bytes for rows of `elem` bytes an element
// (4, 2 or 1), as the kernel lays them out.
extern "C" long long beam_search_smem_bytes(int D, int elem, int m2, int ef,
                                            int T, int threads,
                                            int ring_rows) {
  return static_cast<long long>(
      make_layout(D, elem, m2, ef, T, threads, ring_rows).total);
}

// Blocks of the kernel resident an SM (cudaOccupancyMaxActiveBlocksPer-
// Multiprocessor) for rows of `elem` bytes an element, into *blocks.
// Returns the cudaError_t.
extern "C" int beam_search_occupancy(int elem, int D, int vec, int threads,
                                     long long smem, int* blocks) {
  const size_t s = static_cast<size_t>(smem);
  if (elem == 4) return occupancy<float>(D, vec, threads, s, blocks);
  if (elem == 2) return occupancy<__nv_bfloat16>(D, vec, threads, s, blocks);
  return occupancy<int8_t>(D, vec, threads, s, blocks);
}
