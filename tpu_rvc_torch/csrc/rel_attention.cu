// Banded VITS relative-position self-attention, forward, fp32.
//
// Replaces: tpu_rvc/ops/pallas/rel_attention.py, banded_rel_attention
// (body `_kernel`).  Semantics, per (batch*head b, query row i):
//   s[i,j] = (q_i/sqrt(dk)).k_j + [|j-i| <= W] (q_i/sqrt(dk)).emb_k[j-i+W]
//   s[i,j] = -1e4 for keys j >= len[b]          (set, not added)
//   p      = softmax_j(s)                        (fp32)
//   out_i  = sum_j p[i,j] v_j + sum_{|d|<=W} p[i,i+d] emb_v[d+W]
// Padded query rows (i >= len) keep a softmax over the keys, like the
// Pallas kernel; the encoder zeroes those rows afterwards.
//
// What bounds it on the H100: operations.  At the main path's shape
// (B*H = 2, T = 1598, dk = 96) the function does ~2 GFLOP of fp32 dot
// products against ~5 MB of input, far above the card's fp32
// operations-per-byte balance; the whole call is tens of microseconds of
// work, so launch latency and how many SMs it fills matter as much.
//
// Design: the TPU kernel keeps all of K and V resident in VMEM; at
// T ~ 7100 K alone is 2.7 MB, far beyond a block's 227 KB of shared memory,
// so here one block takes (b, 32-row query tile) and streams K/V through
// shared memory in 64-key tiles, in two passes: pass 1 finds each row's
// max and softmax denominator online, pass 2 recomputes the scores,
// normalises them and accumulates P.V.  The band bias is added only where
// a tile meets |i-j| <= W, and the band probabilities are saved in pass 2
// (21 per row) so the value-band term is one small product at the end.
// 32-row tiles give 100 blocks at the main path's shape instead of 50.
// Each thread computes a 4x4 block of the score tile from shared memory
// (two loads per two FMAs); row reductions use warp shuffles.  Plain fp32
// FMA: no tensor cores in this first version.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int QT = 32;    // query rows per block
constexpr int KT = 64;    // keys per streamed tile
constexpr int NT = 128;   // threads per block
constexpr int MAX_DK = 128;
constexpr int MAX_NB = 33;  // 2W+1 <= 33

struct Smem {
  float* q;    // [QT][dkp]   pre-scaled queries
  float* k;    // [KT][dkp]
  float* v;    // [KT][dkp]   (also holds emb_k while qe is computed)
  float* s;    // [QT][KT+1]  scores, then probabilities
  float* qe;   // [QT][nb]    q . emb_k
  float* pb;   // [QT][nb]    band probabilities
  float* ev;   // [nb][dk]
  float* m;    // [QT]
  float* z;    // [QT]
};

__device__ __forceinline__ Smem carve(float* base, int dk, int nb) {
  const int dkp = dk + 1;
  Smem sm;
  sm.q = base;
  sm.k = sm.q + QT * dkp;
  sm.v = sm.k + KT * dkp;
  sm.s = sm.v + KT * dkp;
  sm.qe = sm.s + QT * (KT + 1);
  sm.pb = sm.qe + QT * nb;
  sm.ev = sm.pb + QT * nb;
  sm.m = sm.ev + nb * dk;
  sm.z = sm.m + QT;
  return sm;
}

// Score tile for this thread: rows rg + 8a, columns cg + 16b (a, b < 4).
__device__ __forceinline__ void score_block(const Smem& sm, int dk, int rg,
                                            int cg, float acc[4][4]) {
  const int dkp = dk + 1;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  for (int d = 0; d < dk; ++d) {
    float qa[4], kb[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) qa[a] = sm.q[(rg + 8 * a) * dkp + d];
#pragma unroll
    for (int b = 0; b < 4; ++b) kb[b] = sm.k[(cg + 16 * b) * dkp + d];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(qa[a], kb[b], acc[a][b]);
  }
}

// Band bias, length mask and out-of-range keys for one score.
__device__ __forceinline__ float finish_score(const Smem& sm, int nb, int W,
                                              float s, int i, int r, int j,
                                              int T, int len) {
  if (j >= T) return -INFINITY;  // not a key at all
  const int rel = j - i;
  if (rel >= -W && rel <= W) s += sm.qe[r * nb + rel + W];
  if (j >= len) s = -1e4f;
  return s;
}

__global__ void __launch_bounds__(NT)
banded_rel_attention_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ emb_k,
                            const float* __restrict__ emb_v,
                            const int* __restrict__ lengths,
                            float* __restrict__ out, int T, int dk, int W) {
  extern __shared__ float smem[];
  const int nb = 2 * W + 1;
  const int dkp = dk + 1;
  Smem sm = carve(smem, dk, nb);
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * QT;
  const int tid = threadIdx.x;
  const int len = lengths[b];
  const float scale = rsqrtf((float)dk);
  const size_t base = (size_t)b * T * dk;

  // queries (scaled), emb_k (into the v buffer), emb_v, band probs
  for (int e = tid; e < QT * dk; e += NT) {
    const int r = e / dk, d = e % dk;
    const int i = i0 + r;
    sm.q[r * dkp + d] = i < T ? q[base + (size_t)i * dk + d] * scale : 0.f;
  }
  for (int e = tid; e < nb * dk; e += NT) {
    const int m = e / dk, d = e % dk;
    sm.v[m * dkp + d] = emb_k[e];
    sm.ev[e] = emb_v[e];
  }
  for (int e = tid; e < QT * nb; e += NT) sm.pb[e] = 0.f;
  __syncthreads();
  for (int e = tid; e < QT * nb; e += NT) {
    const int r = e / nb, m = e % nb;
    float acc = 0.f;
    for (int d = 0; d < dk; ++d)
      acc = fmaf(sm.q[r * dkp + d], sm.v[m * dkp + d], acc);
    sm.qe[e] = acc;
  }
  __syncthreads();

  const int rg = tid & 7, cg = tid >> 3;   // score-tile mapping
  const int srow = tid >> 2, spart = tid & 3;  // row-reduction mapping
  float run_m = -INFINITY, run_z = 0.f;

  // ---- pass 1: row max and softmax denominator --------------------------
  for (int j0 = 0; j0 < T; j0 += KT) {
    for (int e = tid; e < KT * dk; e += NT) {
      const int c = e / dk, d = e % dk;
      const int j = j0 + c;
      sm.k[c * dkp + d] = j < T ? k[base + (size_t)j * dk + d] : 0.f;
    }
    __syncthreads();
    float acc[4][4];
    score_block(sm, dk, rg, cg, acc);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int r = rg + 8 * a, c = cg + 16 * bb;
        sm.s[r * (KT + 1) + c] =
            finish_score(sm, nb, W, acc[a][bb], i0 + r, r, j0 + c, T, len);
      }
    __syncthreads();
    float tmax = -INFINITY;
    for (int c = spart * 16; c < spart * 16 + 16; ++c)
      tmax = fmaxf(tmax, sm.s[srow * (KT + 1) + c]);
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float new_m = fmaxf(run_m, tmax);
    float tsum = 0.f;
    for (int c = spart * 16; c < spart * 16 + 16; ++c)
      tsum += expf(sm.s[srow * (KT + 1) + c] - new_m);
    tsum += __shfl_xor_sync(0xffffffffu, tsum, 1);
    tsum += __shfl_xor_sync(0xffffffffu, tsum, 2);
    run_z = run_z * expf(run_m - new_m) + tsum;
    run_m = new_m;
    __syncthreads();
  }
  if (spart == 0) {
    sm.m[srow] = run_m;
    sm.z[srow] = 1.f / run_z;
  }
  __syncthreads();

  // ---- pass 2: normalised P.V and the band probabilities -----------------
  const int orow = tid >> 2, opart = tid & 3;
  float o[MAX_DK / 4];
#pragma unroll
  for (int e = 0; e < MAX_DK / 4; ++e) o[e] = 0.f;
  for (int j0 = 0; j0 < T; j0 += KT) {
    for (int e = tid; e < KT * dk; e += NT) {
      const int c = e / dk, d = e % dk;
      const int j = j0 + c;
      const bool in = j < T;
      sm.k[c * dkp + d] = in ? k[base + (size_t)j * dk + d] : 0.f;
      sm.v[c * dkp + d] = in ? v[base + (size_t)j * dk + d] : 0.f;
    }
    __syncthreads();
    float acc[4][4];
    score_block(sm, dk, rg, cg, acc);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int r = rg + 8 * a, c = cg + 16 * bb;
        const int i = i0 + r, j = j0 + c;
        const float s = finish_score(sm, nb, W, acc[a][bb], i, r, j, T, len);
        const float p = expf(s - sm.m[r]) * sm.z[r];
        sm.s[r * (KT + 1) + c] = p;
        const int rel = j - i;
        if (j < T && rel >= -W && rel <= W) sm.pb[r * nb + rel + W] = p;
      }
    __syncthreads();
    for (int c = 0; c < KT; ++c) {
      const float p = sm.s[orow * (KT + 1) + c];
#pragma unroll
      for (int e = 0; e < MAX_DK / 4; ++e) {
        const int d = opart + 4 * e;
        if (d < dk) o[e] = fmaf(p, sm.v[c * dkp + d], o[e]);
      }
    }
    __syncthreads();
  }

  // ---- value band term and store -----------------------------------------
  const int i = i0 + orow;
  for (int m = 0; m < nb; ++m) {
    const float p = sm.pb[orow * nb + m];
#pragma unroll
    for (int e = 0; e < MAX_DK / 4; ++e) {
      const int d = opart + 4 * e;
      if (d < dk) o[e] = fmaf(p, sm.ev[m * dk + d], o[e]);
    }
  }
  if (i < T) {
#pragma unroll
    for (int e = 0; e < MAX_DK / 4; ++e) {
      const int d = opart + 4 * e;
      if (d < dk) out[base + (size_t)i * dk + d] = o[e];
    }
  }
}

size_t smem_bytes(int dk, int nb) {
  const int dkp = dk + 1;
  return sizeof(float) * ((size_t)QT * dkp + 2 * KT * dkp + QT * (KT + 1) +
                          2 * QT * nb + nb * dk + 2 * QT);
}

}  // namespace

extern "C" int banded_rel_attention_f32(const float* q, const float* k,
                                        const float* v, const float* emb_k,
                                        const float* emb_v, const int* lengths,
                                        float* out, int BH, int T, int dk,
                                        int W, cudaStream_t stream) {
  if (dk < 1 || dk > MAX_DK || 2 * W + 1 > MAX_NB || W < 0 || T < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(dk, 2 * W + 1);
  cudaError_t err = cudaFuncSetAttribute(
      banded_rel_attention_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + QT - 1) / QT, BH);
  banded_rel_attention_kernel<<<grid, NT, smem, stream>>>(
      q, k, v, emb_k, emb_v, lengths, out, T, dk, W);
  return (int)cudaGetLastError();
}
