// RMVPE's bidirectional GRU (hidden 256, one layer), forward: the whole
// recurrence of both directions in one launch, fp32 FMA.
//
// Replaces: no TPU kernel.  The JAX package runs the recurrence as one
// lax.scan over both directions (tpu_rvc/models/rmvpe.py, `_bigru_fused`);
// the port handed it to cuDNN's GRU, which at batch 1 queues a small GEMV
// and an RNN-cell kernel for every frame and direction, paced by the host.
// The input projection gi = x.W_ih^T + b_ih of both directions is one
// matrix product before the launch (`ops/kernels/bigru.py`); this kernel
// takes gi and runs, per direction and step, in torch's gate order:
//   gh = W_hh h + b_hh                             (768 = r, z, n rows)
//   r = sigmoid(gi_r + gh_r),  z = sigmoid(gi_z + gh_z)
//   n = tanh(gi_n + r * gh_n), h' = (1 - z) * n + z * h,  h_0 = 0
// The backward direction walks t = T-1 .. 0.  y (B, T, 512) is nn.GRU's
// layout: forward units in [:256], backward in [256:].
//
// What bounds it on the H100: not operations (2 x 196,608 multiply-adds a
// step and row, 0.4 MFLOP) nor bytes, but the latency of one step times T,
// since step t needs all 256 units of step t-1.  So the design keeps the
// whole recurrence on the chip and makes a step as short as it can be.
//
// Design.
// * One thread-block cluster of 8 CTAs (the portable maximum) per direction
//   and slice of R batch rows; CTA `rank` owns hidden units
//   [32 rank, 32 rank + 32): its 96 gate rows of W_hh (r, z, n) x 256
//   inputs, 96 KB, are held in registers for the whole run (96 a thread),
//   which every step reads at no cost; shared memory would be read 96 KB a
//   step, some 0.4 us of a step's budget.
// * 256 threads: thread (u = tid / 8, kc = tid % 8) takes the three gate
//   rows of unit u over inputs {32 i + 4 kc + e}, i < 8, e < 4 (eight
//   float4s of h, conflict-free); three xor shuffles over the 8 lanes of kc
//   give every one of them the same full sums, in the same order.
// * Each of those 8 lanes then computes the cell (redundantly, and so
//   identically) and stores h' for its rows into the next step's h buffer
//   of cluster rank kc through distributed shared memory: the 32 units of
//   each CTA reach all 8 CTAs with one store a thread and row.
// * One cluster barrier a step, split: arrive (release) right after the
//   stores, the output stores and the register copy of the prefetched gi
//   in between, then wait (acquire).  h is double-buffered, so a CTA that
//   runs ahead writes the buffer its peers have finished reading.
// * gi of step t+1 is loaded into registers at the start of step t; its
//   latency hides behind the dot products and the barrier.
// * Numbers: fp32 FMA, expf/tanhf (no fast math), explicit fmaf and
//   rounded sums and products in the cell, built with -fmad=false so the
//   compiler fuses nothing else; the only difference from cuDNN is the
//   order of the sums.  A row's arithmetic does not depend on R, B or the
//   cluster that runs it, so any batch split gives the same bits.
// * R (1, 2, 4 or 8 rows a cluster) is the least that lets all 2 ceil(B/R)
//   clusters be resident at once (`cudaOccupancyMaxActiveClusters`); more
//   clusters than that run in waves.  T is any length >= 1.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int H = 256;        // hidden units a direction
constexpr int G = 3 * H;      // gate rows a direction: r, z, n
constexpr int CL = 8;         // CTAs a cluster
constexpr int U = H / CL;     // hidden units a CTA
constexpr int NT = 8 * U;     // threads: 8 input slices a unit
constexpr int KQ = H / 32;    // float4s of h (and of a W_hh row) a thread

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int R>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(NT, 1)
    bigru_kernel(const float* __restrict__ gi, const float* __restrict__ whh_f,
                 const float* __restrict__ whh_b,
                 const float* __restrict__ bhh_f,
                 const float* __restrict__ bhh_b, float* __restrict__ y,
                 int B, int T) {
  __shared__ __align__(16) float hs[2][R][H];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / CL;
  const int d = cid & 1;              // 0 forward, 1 backward
  const int b0 = (cid >> 1) * R;      // first batch row of the cluster
  const int u = threadIdx.x >> 3;
  const int kc = threadIdx.x & 7;
  const int j = rank * U + u;         // the hidden unit of this thread
  const float* whh = d ? whh_b : whh_f;
  const float* bhh = d ? bhh_b : bhh_f;

  float4 w[3][KQ];
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int i = 0; i < KQ; ++i)
      w[g][i] = __ldg(reinterpret_cast<const float4*>(
                          whh + (size_t)(g * H + j) * H) + kc + 8 * i);
  const float bh_r = __ldg(bhh + j), bh_z = __ldg(bhh + H + j),
              bh_n = __ldg(bhh + 2 * H + j);

  for (int e = threadIdx.x; e < R * H; e += NT) (&hs[0][0][0])[e] = 0.0f;
  // lane kc stores into the h buffers of cluster rank kc
  float* peer = cluster.map_shared_rank(&hs[0][0][0], kc);

  // gi of (row b0 + r, time tt, this direction) for this thread's unit
  const size_t row_stride = (size_t)T * 2 * G;
  const float* gi_d = gi + (size_t)d * G + j;
  float gc[R][3], gn[R][3];
  {
    const int tt = d ? T - 1 : 0;
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int g = 0; g < 3; ++g)
        gc[r][g] = b0 + r < B
                       ? __ldg(gi_d + (b0 + r) * row_stride +
                               (size_t)tt * 2 * G + g * H)
                       : 0.0f;
  }
  cluster.sync();  // every CTA running, every h_0 zeroed

  for (int t = 0; t < T; ++t) {
    const int cur = t & 1;
    const int tt = d ? T - 1 - t : t;
    const int tn = d ? tt - 1 : tt + 1;
    const bool more = t + 1 < T;
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int g = 0; g < 3; ++g)
        gn[r][g] = more && b0 + r < B
                       ? __ldg(gi_d + (b0 + r) * row_stride +
                               (size_t)tn * 2 * G + g * H)
                       : 0.0f;

    float acc[R][3];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4* hv = reinterpret_cast<const float4*>(hs[cur][r]) + kc;
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
#pragma unroll
      for (int i = 0; i < KQ; ++i) {
        const float4 h4 = hv[8 * i];
        a0 = fmaf(w[0][i].x, h4.x, a0);
        a0 = fmaf(w[0][i].y, h4.y, a0);
        a0 = fmaf(w[0][i].z, h4.z, a0);
        a0 = fmaf(w[0][i].w, h4.w, a0);
        a1 = fmaf(w[1][i].x, h4.x, a1);
        a1 = fmaf(w[1][i].y, h4.y, a1);
        a1 = fmaf(w[1][i].z, h4.z, a1);
        a1 = fmaf(w[1][i].w, h4.w, a1);
        a2 = fmaf(w[2][i].x, h4.x, a2);
        a2 = fmaf(w[2][i].y, h4.y, a2);
        a2 = fmaf(w[2][i].z, h4.z, a2);
        a2 = fmaf(w[2][i].w, h4.w, a2);
      }
      acc[r][0] = a0;
      acc[r][1] = a1;
      acc[r][2] = a2;
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int g = 0; g < 3; ++g)
          acc[r][g] = __fadd_rn(acc[r][g],
                                __shfl_xor_sync(0xffffffffu, acc[r][g], off));

    float hn[R];
    float* dst = peer + (cur ^ 1) * R * H + j;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float hp = hs[cur][r][j];
      const float rg =
          sigmoid_f(__fadd_rn(gc[r][0], __fadd_rn(acc[r][0], bh_r)));
      const float zg =
          sigmoid_f(__fadd_rn(gc[r][1], __fadd_rn(acc[r][1], bh_z)));
      const float ng = tanhf(fmaf(rg, __fadd_rn(acc[r][2], bh_n), gc[r][2]));
      hn[r] = fmaf(zg, hp, __fmul_rn(__fsub_rn(1.0f, zg), ng));
      dst[r * H] = hn[r];
    }
    cluster_arrive();
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (kc == (r & 7) && b0 + r < B)
        y[((size_t)(b0 + r) * T + tt) * 2 * H + d * H + j] = hn[r];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int g = 0; g < 3; ++g) gc[r][g] = gn[r][g];
    cluster_wait();
  }
}

template <int R>
int max_active_clusters(int* out) {
  static int n = 0;  // identical cards share it, as resblock.cu's SM count
  if (n == 0) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(CL * 256);
    cfg.blockDim = dim3(NT);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CL;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t err = cudaOccupancyMaxActiveClusters(
        &n, (void*)bigru_kernel<R>, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (n < 1) return (int)cudaErrorInvalidConfiguration;
  }
  *out = n;
  return 0;
}

template <int R>
int launch(const float* gi, const float* whh_f, const float* whh_b,
           const float* bhh_f, const float* bhh_b, float* y, int B, int T,
           cudaStream_t stream) {
  const int clusters = 2 * ((B + R - 1) / R);
  bigru_kernel<R><<<clusters * CL, NT, 0, stream>>>(gi, whh_f, whh_b, bhh_f,
                                                    bhh_b, y, B, T);
  return (int)cudaGetLastError();
}

// the least R of 1, 2, 4, 8 whose 2 ceil(B / R) clusters are all resident,
// else 8; -(CUDA error) when the occupancy query fails
int rows_per_cluster(int B) {
  int n = 0, rc = 0;
  if ((rc = max_active_clusters<1>(&n)) != 0) return -rc;
  if (2 * B <= n) return 1;
  if ((rc = max_active_clusters<2>(&n)) != 0) return -rc;
  if (2 * ((B + 1) / 2) <= n) return 2;
  if ((rc = max_active_clusters<4>(&n)) != 0) return -rc;
  if (2 * ((B + 3) / 4) <= n) return 4;
  return 8;
}

}  // namespace

// gi: (B, T, 2, 768) contiguous fp32, x.W_ih^T + b_ih of the forward (index
// 0) and backward (1) direction; whh_f, whh_b: (768, 256) contiguous, 16-byte
// aligned; bhh_f, bhh_b: (768,); y: (B, T, 512).  B >= 1, T >= 1.
extern "C" int bigru_fp32(const float* gi, const float* whh_f,
                          const float* whh_b, const float* bhh_f,
                          const float* bhh_b, float* y, int B, int T,
                          cudaStream_t stream) {
  if (B < 1 || T < 1) return (int)cudaErrorInvalidValue;
  const int R = rows_per_cluster(B);
  if (R < 0) return -R;
  switch (R) {
    case 1:
      return launch<1>(gi, whh_f, whh_b, bhh_f, bhh_b, y, B, T, stream);
    case 2:
      return launch<2>(gi, whh_f, whh_b, bhh_f, bhh_b, y, B, T, stream);
    case 4:
      return launch<4>(gi, whh_f, whh_b, bhh_f, bhh_b, y, B, T, stream);
  }
  return launch<8>(gi, whh_f, whh_b, bhh_f, bhh_b, y, B, T, stream);
}
