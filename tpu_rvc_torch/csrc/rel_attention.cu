// Banded VITS relative-position self-attention, forward, on Hopper's tensor
// cores: one pass, 3xTF32 (fp32-accurate) through mma.sync.
//
// Replaces: tpu_rvc/ops/pallas/rel_attention.py, banded_rel_attention
// (body `_kernel`).  Semantics, per (batch*head b, query row i):
//   s[i,j] = (q_i/sqrt(dk)).k_j + [|j-i| <= W] (q_i/sqrt(dk)).emb_k[j-i+W]
//   s[i,j] = -1e4 for keys j >= len[b]          (set, not added)
//   p      = softmax_j(s)                        (fp32)
//   out_i  = sum_j p[i,j] v_j + sum_{|d|<=W} p[i,i+d] emb_v[d+W]
// Padded query rows (i >= len) keep a softmax over the keys, like the
// Pallas kernel; the encoder zeroes those rows afterwards.  Keys at or
// beyond the length are not skipped: every tile is walked and its scores
// set to -1e4, so the result is the plain version's for any length.
//
// What bounds it on the H100: at the main path's shape (B*H = 2, T = 1598,
// dk = 96) the function does 1.8 GFLOP of fp32 products against 5 MB of
// input, 0.011 ms at the 3xTF32 peak (495 / 3 = 165 TFLOP/s): operations
// in name, but so few that the length of one warp's instruction stream
// and how many SMs the call fills decide its time, not the peak.
//
// Design.
// * One pass.  Q.K^T is computed once; softmax runs online (running row
//   max and denominator, the output accumulator rescaled when the max
//   moves).  The band probabilities are needed under the FINAL max and
//   denominator, so the 2W+1 raw band scores of a row are parked in shared
//   memory as the diagonal tiles pass, and exp(s - m) / z is formed at the
//   end, for the value-band term sum_d p[i,i+d] emb_v[d+W].
// * Tensor cores: mma.sync.aligned.m16n8k8 TF32, three products for one
//   fp32 product (hi = cvt.rna.tf32(x), lo = tf32(x - hi); lo.hi + hi.lo +
//   hi.hi, small terms first, fp32 accumulators).  mma.sync and not wgmma:
//   a warp owns 16 query rows and keeps P in registers between the two
//   products, because the accumulator fragment of Q.K^T is the A fragment
//   of P.V once the 8 keys of a block are taken in the order (0, 2, 4, 6,
//   1, 3, 5, 7), which is free: the sum over keys has no order, and V's
//   fragment is loaded in the same one.  wgmma would need 64 query rows a
//   warpgroup, 50 blocks for 132 SMs at this shape, and P through shared
//   memory.  Q's fragments stay in registers, split once.
// * Filling the card: a block is 32 query rows by two key groups, four
//   warps: warps 0-1 take the first 32 keys of every 64-key tile and warps
//   2-3 the other 32, each with its own running max, denominator and
//   output, merged through shared memory at the end.  That is 100 blocks
//   of four warps at the main path's shape, and each warp's stream is half
//   as long as with one warp per 16 rows.
// * K and V tiles (fp32) arrive by cp.async, double-buffered, rows beyond T
//   zero-filled; a row's stride is dk + 4 words, which makes both the K
//   fragment loads (8 keys x 4 words) and the V fragment loads (4 key
//   pairs x 8 words) free of bank conflicts.
// * q.emb_k (16 x (2W+1) per warp) runs on the same tensor-core path once
//   per warp; the value-band term (21 terms per output) is plain fp32 FMA.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QT = 32;      // query rows per block: two warps of 16
constexpr int KT = 64;      // keys per staged tile: 32 per key group
constexpr int NT = 128;     // threads per block
constexpr int MAX_NB = 33;  // 2W+1 <= 33
constexpr int NBP = 40;     // band columns, padded to whole 8-column blocks

template <int DK>
struct Lay {  // shared memory, in floats
  static constexpr int LD = DK + 4;           // K / V / emb_k row stride
  static constexpr int K = 0;                 // [2][KT][LD]
  static constexpr int V = K + 2 * KT * LD;   // [2][KT][LD]
  static constexpr int EK = V + 2 * KT * LD;  // [NBP][LD], rows >= 2W+1 zero
  static constexpr int EV = EK + NBP * LD;    // [MAX_NB][DK]
  static constexpr int QE = EV + MAX_NB * DK; // [4 warps][16][NBP] q.emb_k,
                                              // later the band probabilities
  static constexpr int BAND = QE + 4 * 16 * NBP;  // [QT][NBP] raw band scores
  static constexpr int STAT = BAND + QT * NBP;    // [QT][2] final max, 1/z
  static constexpr int TOTAL = STAT + 2 * QT;
  static constexpr int MERGE = 16 * DK + 32;  // per row-warp, over the K tiles
};

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d (16 x 8) += a (16 x 8) . b (8 x 8), TF32 in, fp32 out.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b as 3xTF32, b given in fp32 and split here.
__device__ __forceinline__ void mma_3x(float (&d)[4], const uint32_t (&a_hi)[4],
                                       const uint32_t (&a_lo)[4], float b0,
                                       float b1) {
  uint32_t h0, l0, h1, l1;
  tf32_split(b0, h0, l0);
  tf32_split(b1, h1, l1);
  mma_tf32(d, a_lo, h0, h1);
  mma_tf32(d, a_hi, l0, l1);
  mma_tf32(d, a_hi, h0, h1);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

template <int DK>
__global__ void __launch_bounds__(NT)
banded_rel_attention_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ emb_k,
                            const float* __restrict__ emb_v,
                            const int* __restrict__ lengths,
                            float* __restrict__ out, int T, int W) {
  using L = Lay<DK>;
  constexpr int LD = L::LD;
  constexpr int NK = DK / 8;  // k-steps of Q.K^T, d-blocks of P.V
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int rw = warp & 1;   // which 16 rows of the block
  const int kg = warp >> 1;  // which 32 keys of every tile
  const int b = blockIdx.y;
  const int iw = blockIdx.x * QT + 16 * rw;  // this warp's first query row
  const int len = lengths[b];
  const int nb = 2 * W + 1;
  const size_t base = (size_t)b * T * DK;
  float* qe_w = sm + L::QE + warp * 16 * NBP;
  float* band = sm + L::BAND + 16 * rw * NBP;

  // One 64-key tile of K and V into buffer `st`; rows >= T are zero-filled.
  auto prefetch = [&](int t, int st) {
    for (int e = tid; e < KT * (DK / 4); e += NT) {
      const int row = e / (DK / 4), c4 = e % (DK / 4);
      const int j = t * KT + row;
      const size_t src = base + (size_t)(j < T ? j : 0) * DK + 4 * c4;
      const int dst = (st * KT + row) * LD + 4 * c4;
      cp_async16(sm + L::K + dst, k + src, j < T ? 16 : 0);
      cp_async16(sm + L::V + dst, v + src, j < T ? 16 : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  prefetch(0, 0);

  for (int e = tid; e < NBP * DK; e += NT) {
    const int m = e / DK, d = e % DK;
    sm[L::EK + m * LD + d] = m < nb ? emb_k[e] : 0.f;
  }
  for (int e = tid; e < nb * DK; e += NT) sm[L::EV + e] = emb_v[e];

  // This warp's 16 query rows, scaled, as A fragments: element e of step kk
  // is row g + 8 (e % 2), column 8 kk + c + 4 (e / 2).
  uint32_t q_hi[NK][4], q_lo[NK][4];
  const float scale = 1.f / sqrtf((float)DK);
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = iw + g + 8 * (e & 1), col = 8 * kk + c + 4 * (e >> 1);
      const float x = row < T ? q[base + (size_t)row * DK + col] * scale : 0.f;
      tf32_split(x, q_hi[kk][e], q_lo[kk][e]);
    }
  __syncthreads();

  // q . emb_k for these rows: accumulator element e of column block n is
  // row g + 8 (e / 2), column 8 n + 2 c + e % 2.
#pragma unroll
  for (int n = 0; n < NBP / 8; ++n) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    const float* ek = sm + L::EK + (8 * n + g) * LD + c;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
      mma_3x(acc, q_hi[kk], q_lo[kk], ek[8 * kk], ek[8 * kk + 4]);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      qe_w[(g + 8 * (e >> 1)) * NBP + 8 * n + 2 * c + (e & 1)] = acc[e];
  }
  __syncwarp();

  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
  float z_run[2] = {0.f, 0.f};              // this thread's share of the sum
  float o[NK][4];
#pragma unroll
  for (int n = 0; n < NK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  const int ntiles = (T + KT - 1) / KT;
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      prefetch(t + 1, (t + 1) & 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const float* kt = sm + L::K + ((t & 1) * KT + 32 * kg) * LD;
    const float* vt = sm + L::V + ((t & 1) * KT + 32 * kg) * LD;
    const int j0 = t * KT + 32 * kg;

    // scores of 16 rows x 32 keys: s[n][e] is key block n, element e
    float s[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float* kp = kt + (8 * n + g) * LD + 8 * kk + c;
        mma_3x(s[n], q_hi[kk], q_lo[kk], kp[0], kp[4]);
      }

    // band bias, length mask, keys beyond T; park the raw band scores
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int blk = j0 + 8 * n;
      const bool near = blk + 7 >= iw - W && blk <= iw + 15 + W;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + 8 * (e >> 1);
        const int j = blk + 2 * c + (e & 1);
        const int rel = j - (iw + r);
        const bool in_band = near && rel >= -W && rel <= W;
        float x = s[n][e];
        if (in_band) x += qe_w[r * NBP + rel + W];
        if (j >= len) x = -1e4f;
        if (j >= T) x = -INFINITY;
        else if (in_band) band[r * NBP + rel + W] = x;
        s[n][e] = x;
      }
    }

    // online softmax, rows g (elements 0, 1) and g + 8 (elements 2, 3)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < 4; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[h], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m_run[h] - m_use);
      m_run[h] = m_new;
      float zs = 0.f;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float p0 = expf(s[n][2 * h] - m_use);
        const float p1 = expf(s[n][2 * h + 1] - m_use);
        s[n][2 * h] = p0;
        s[n][2 * h + 1] = p1;
        zs += p0 + p1;
      }
      z_run[h] = z_run[h] * alpha + zs;
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        o[n][2 * h] *= alpha;
        o[n][2 * h + 1] *= alpha;
      }
    }

    // P.V: key block n in the order (0, 2, 4, 6, 1, 3, 5, 7), so that the
    // score fragment is the A fragment as it stands
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      uint32_t p_hi[4], p_lo[4];
      tf32_split(s[n][0], p_hi[0], p_lo[0]);
      tf32_split(s[n][2], p_hi[1], p_lo[1]);
      tf32_split(s[n][1], p_hi[2], p_lo[2]);
      tf32_split(s[n][3], p_hi[3], p_lo[3]);
      const float* vp = vt + (8 * n + 2 * c) * LD + g;
#pragma unroll
      for (int d = 0; d < NK; ++d)
        mma_3x(o[d], p_hi, p_lo, vp[8 * d], vp[LD + 8 * d]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    z_run[h] += __shfl_xor_sync(0xffffffffu, z_run[h], 1);
    z_run[h] += __shfl_xor_sync(0xffffffffu, z_run[h], 2);
  }

  // merge the two key groups: group 1 hands over through the tile buffers
  float* mrg = sm + L::K + rw * L::MERGE;
  if (kg == 1) {
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mrg[(g + 8 * (e >> 1)) * DK + 8 * n + 2 * c + (e & 1)] = o[n][e];
    if (c == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mrg[16 * DK + g + 8 * h] = m_run[h];
        mrg[16 * DK + 16 + g + 8 * h] = z_run[h];
      }
    }
  }
  __syncthreads();
  if (kg == 1) return;

  float* stat = sm + L::STAT + 2 * 16 * rw;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = g + 8 * h;
    const float m1 = mrg[16 * DK + r], z1 = mrg[16 * DK + 16 + r];
    const float mf = fmaxf(m_run[h], m1);  // finite: key 0 is in group 0
    const float a0 = expf(m_run[h] - mf), a1 = expf(m1 - mf);
    const float inv = 1.f / (z_run[h] * a0 + z1 * a1);
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        o[n][2 * h + e] =
            (o[n][2 * h + e] * a0 + mrg[r * DK + 8 * n + 2 * c + e] * a1) * inv;
    if (c == 0) {
      stat[2 * r] = mf;
      stat[2 * r + 1] = inv;
    }
  }
  __syncwarp();

  // band probabilities under the final max and denominator (over qe_w)
  for (int e = lane; e < 16 * nb; e += 32) {
    const int r = e / nb, m = e % nb;
    const int j = iw + r + m - W;
    qe_w[r * NBP + m] =
        j >= 0 && j < T
            ? expf(band[r * NBP + m] - stat[2 * r]) * stat[2 * r + 1]
            : 0.f;
  }
  __syncwarp();
  for (int m = 0; m < nb; ++m) {
    const float p0 = qe_w[g * NBP + m], p1 = qe_w[(g + 8) * NBP + m];
    const float* ev = sm + L::EV + m * DK + 2 * c;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      const float2 w = *reinterpret_cast<const float2*>(ev + 8 * n);
      o[n][0] = fmaf(p0, w.x, o[n][0]);
      o[n][1] = fmaf(p0, w.y, o[n][1]);
      o[n][2] = fmaf(p1, w.x, o[n][2]);
      o[n][3] = fmaf(p1, w.y, o[n][3]);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = iw + g + 8 * h;
    if (i >= T) continue;
    float* dst = out + base + (size_t)i * DK + 2 * c;
#pragma unroll
    for (int n = 0; n < NK; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) =
          make_float2(o[n][2 * h], o[n][2 * h + 1]);
  }
}

template <int DK>
int launch(const float* q, const float* k, const float* v, const float* emb_k,
           const float* emb_v, const int* lengths, float* out, int BH, int T,
           int W, cudaStream_t stream) {
  const int smem = Lay<DK>::TOTAL * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      banded_rel_attention_kernel<DK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + QT - 1) / QT, BH);
  banded_rel_attention_kernel<DK><<<grid, NT, smem, stream>>>(
      q, k, v, emb_k, emb_v, lengths, out, T, W);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out: (BH, T, dk) contiguous fp32, 16-byte aligned; emb_k, emb_v:
// (2W+1, dk); lengths: (BH,) int32.  dk is 32, 64, 96 or 128; W at most 16.
extern "C" int banded_rel_attention_3xtf32(
    const float* q, const float* k, const float* v, const float* emb_k,
    const float* emb_v, const int* lengths, float* out, int BH, int T, int dk,
    int W, cudaStream_t stream) {
  if (2 * W + 1 > MAX_NB || W < 0 || T < 1 || BH < 1)
    return (int)cudaErrorInvalidValue;
  switch (dk) {
    case 32:
      return launch<32>(q, k, v, emb_k, emb_v, lengths, out, BH, T, W, stream);
    case 64:
      return launch<64>(q, k, v, emb_k, emb_v, lengths, out, BH, T, W, stream);
    case 96:
      return launch<96>(q, k, v, emb_k, emb_v, lengths, out, BH, T, W, stream);
    case 128:
      return launch<128>(q, k, v, emb_k, emb_v, lengths, out, BH, T, W, stream);
  }
  return (int)cudaErrorInvalidValue;
}
