// One-token GQA decode attention with an online softmax, fp32, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_decode.py
// (flash_decode_pallas / _kernel): out[b, h] = softmax(q[b, h] . K[b]^T
// * Dh^-0.5, masked at positions >= cur_len[b]) . V[b], with query head h
// reading KV head h / G (G = H / KVH query heads per KV head, the
// q.reshape(b, kvh, g, dh) grouping of the plain version,
// repro_torch/kernels/ref.py:flash_decode_ref).
//
// What bounds it on this card: bytes. Every live cache position is read
// once (K and V rows of Dh floats) for about 4*G*Dh flops, a few flops per
// byte. The TPU kernel walked S tiles as a sequential grid dimension with
// (m, l, acc) carried in scratch. Blocks here run in parallel and in no
// order, so the sequence is split instead (flash-decoding): block
// (b, kv head, split) walks the tiles of its own slice of the sequence,
// the G query heads of the group sharing every K/V row it loads, and
// writes its partial (m, l, acc); a second kernel merges the splits of
// each (b, head). The wrapper picks the split count so that B * KVH *
// splits fills the card (B * KVH alone is 32-64 blocks on the decode
// path, a quarter of the 132 SMs). Per tile of kTile positions a block
//   1. stages the K and V rows in shared memory with coalesced loads (the
//      K tile is padded to Dh + 1 floats a row, so the score loop's
//      column reads hit distinct banks);
//   2. computes the G x kTile scores;
//   3. updates the running max m and sum l per head (one warp per head)
//      and turns the scores into p = exp(s - m);
//   4. rescales acc by exp(m_old - m) and adds p . V, one thread per
//      (head, column).
// Only tiles below cur_len[b] are visited, so the masked tail of the
// cache is never read: its softmax weight is exactly zero in the plain
// version too; a split wholly past cur_len[b] reports (m, l) = (-1e30, 0)
// and weighs nothing in the merge. (At cur_len = 0 this kernel writes
// zeros where the plain version averages V uniformly; the decode path never
// passes 0.)
//
// Plain C interface (no PyTorch headers), loaded with ctypes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;

__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const float* __restrict__ q,        // [B, H, Dh]
                    const float* __restrict__ k,        // [B, S, KVH, Dh]
                    const float* __restrict__ v,        // [B, S, KVH, Dh]
                    const int32_t* __restrict__ cur_len,  // [B]
                    float* __restrict__ part_acc,  // [B, H, splits, Dh]
                    float* __restrict__ part_ml,   // [B, H, splits, 2]
                    int H, int S, int KVH, int Dh, int chunk, float scale) {
  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int split = blockIdx.z;
  const int splits = gridDim.z;
  const int G = H / KVH;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;                       // [G][Dh], pre-scaled
  float* acc_s = q_s + G * Dh;             // [G][Dh]
  float* k_s = acc_s + G * Dh;             // [kTile][Dh + 1]
  float* v_s = k_s + kTile * (Dh + 1);     // [kTile][Dh]
  float* p_s = v_s + kTile * Dh;           // [G][kTile]
  float* m_s = p_s + G * kTile;            // [G]
  float* l_s = m_s + G;                    // [G]
  float* alpha_s = l_s + G;                // [G]

  int len = cur_len[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  const int t_begin = split * chunk;           // this split's positions
  const int t_end = min(len, t_begin + chunk);

  for (int i = tid; i < G * Dh; i += blockDim.x) {
    const int g = i / Dh, d = i - (i / Dh) * Dh;
    q_s[i] = q[((size_t)b * H + (size_t)kh * G + g) * Dh + d] * scale;
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += blockDim.x) {
    m_s[g] = -1e30f;
    l_s[g] = 0.f;
  }
  __syncthreads();

  const size_t pos_stride = (size_t)KVH * Dh;  // floats between positions
  const float* kb = k + (size_t)b * S * pos_stride + (size_t)kh * Dh;
  const float* vb = v + (size_t)b * S * pos_stride + (size_t)kh * Dh;

  for (int t0 = t_begin; t0 < t_end; t0 += kTile) {
    const int n = min(kTile, t_end - t0);
    // 1. stage the tile's K and V rows
    for (int i = tid; i < n * Dh; i += blockDim.x) {
      const int t = i / Dh, d = i - (i / Dh) * Dh;
      const size_t off = (size_t)(t0 + t) * pos_stride + d;
      k_s[t * (Dh + 1) + d] = __ldg(kb + off);
      v_s[t * Dh + d] = __ldg(vb + off);
    }
    __syncthreads();
    // 2. scores of the G heads against the n live positions
    for (int i = tid; i < G * kTile; i += blockDim.x) {
      const int g = i / kTile, t = i - (i / kTile) * kTile;
      float s = -1e30f;
      if (t < n) {
        const float* qg = q_s + g * Dh;
        const float* kt = k_s + t * (Dh + 1);
        float a = 0.f;
        for (int d = 0; d < Dh; ++d) a = fmaf(qg[d], kt[d], a);
        s = a;
      }
      p_s[i] = s;
    }
    __syncthreads();
    // 3. online-softmax statistics, one warp per head
    for (int g = warp; g < G; g += nwarps) {
      float mx = -1e30f;
      for (int t = lane; t < n; t += 32) mx = fmaxf(mx, p_s[g * kTile + t]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < kTile; t += 32) {
        const float p = t < n ? expf(p_s[g * kTile + t] - m_new) : 0.f;
        p_s[g * kTile + t] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      if (lane == 0) {
        // first tile: m_old = -1e30 and exp underflows to exactly 0
        const float alpha = expf(m_old - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // 4. acc = acc * alpha + p . V
    for (int i = tid; i < G * Dh; i += blockDim.x) {
      const int g = i / Dh, d = i - (i / Dh) * Dh;
      const float* pg = p_s + g * kTile;
      float a = acc_s[i] * alpha_s[g];
      for (int t = 0; t < n; ++t) a = fmaf(pg[t], v_s[t * Dh + d], a);
      acc_s[i] = a;
    }
    __syncthreads();
  }

  // this split's partial: unnormalised acc and its (m, l)
  for (int i = tid; i < G * Dh; i += blockDim.x) {
    const int g = i / Dh, d = i - (i / Dh) * Dh;
    const size_t row = ((size_t)b * H + (size_t)kh * G + g) * splits + split;
    part_acc[row * Dh + d] = acc_s[i];
  }
  for (int g = tid; g < G; g += blockDim.x) {
    const size_t row = ((size_t)b * H + (size_t)kh * G + g) * splits + split;
    part_ml[row * 2] = m_s[g];
    part_ml[row * 2 + 1] = l_s[g];
  }
}

// Merge the splits of one (b, head): out = sum_s w_s acc_s / sum_s w_s l_s
// with w_s = exp(m_s - max_s m_s). One block per (b, head), one thread per
// column.
__global__ void flash_decode_merge_kernel(const float* __restrict__ part_acc,
                                          const float* __restrict__ part_ml,
                                          float* __restrict__ out,
                                          int splits, int Dh) {
  const size_t bh = blockIdx.x;
  const float* ml = part_ml + bh * splits * 2;
  float m = -1e30f;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, ml[s * 2]);
  for (int d = threadIdx.x; d < Dh; d += blockDim.x) {
    float num = 0.f, den = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float w = expf(ml[s * 2] - m);
      num = fmaf(w, part_acc[(bh * splits + s) * Dh + d], num);
      den = fmaf(w, ml[s * 2 + 1], den);
    }
    out[bh * Dh + d] = num / fmaxf(den, 1e-30f);
  }
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q [B, H, Dh], k/v [B, S, KVH, Dh], cur_len [B] i32 -> out [B, H, Dh], all
// fp32 and contiguous; H % KVH == 0. scale = Dh^-0.5 as the caller rounds
// it. part_acc [B, H, splits, Dh] and part_ml [B, H, splits, 2] are the
// caller's scratch; each split covers `chunk` positions (a multiple of the
// tile). Returns the first launch error (0 on success).
extern "C" int flash_decode_f32(const void* q, const void* k, const void* v,
                                const void* cur_len, void* out,
                                void* part_acc, void* part_ml, int B, int H,
                                int S, int KVH, int Dh, int splits, int chunk,
                                float scale, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  const int G = H / KVH;
  const size_t floats = (size_t)2 * G * Dh + (size_t)kTile * (Dh + 1) +
                        (size_t)kTile * Dh + (size_t)G * kTile + 3 * G;
  const size_t smem = floats * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(B, KVH, splits);
  flash_decode_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int32_t*>(cur_len),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), H, S, KVH,
      Dh, chunk, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int threads = Dh < 1024 ? Dh : 1024;
  flash_decode_merge_kernel<<<B * H, threads, 0, st>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<float*>(out), splits, Dh);
  return (int)cudaGetLastError();
}
