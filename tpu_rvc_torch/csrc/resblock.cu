// HiFiGAN ResBlock1 stage, fp32: one conv of the chain per launch.
//
// Replaces: tpu_rvc/ops/pallas/resblock.py, fused_stage (body
// `_stage_kernel`) and fused_resblock (body `_kernel`): the latter is the
// one-resblock case of the same launches.  A stage computes
//   out = mean_r ResBlock1_{k_r}(x),
//   ResBlock1_k: for d in dilations: x += conv_{k,1}(lrelu(conv_{k,d}(lrelu(x))))
// with slope 0.1 and same padding on the true length T: rows outside
// [0, T) are zero before every conv, the intermediate included.
//
// Each (resblock, dilation) pair is two launches of `conv_kernel`:
//   u     = lrelu(conv_{k,d}(lrelu(x_in)) + b1)   (u exists on [0, T) only)
//   x_new = x_in + conv_{k,1}(u) + b2
// and the second stores x_new for the next pair and/or adds x_new / n_rb
// into the stage output (the last pair of each resblock).  A stage of 3
// resblocks is 18 launches, one resblock 6.
//
// What bounds it on the H100: operations.  A conv does 2 C^2 k T FLOPs
// against 8 C T bytes of activations (in read, out written): 704 FLOP per
// byte at C = 64, k = 11, far above the fp32 balance (20 FLOP/byte at
// 67 TFLOP/s and 3.35 TB/s).  So the design spends bytes to keep the FMA
// units fed: the intermediate u makes a round trip through device memory
// (2 x 4 C T bytes per pair, 9 pairs a stage, about 1.7 ms of HBM time for
// the whole v2/48k decoder) instead of being recomputed over a halo in
// shared memory.  A fused design that keeps u in shared memory (the TPU
// kernel's approach, with a 60-row halo at k = 11) fits one 256-thread
// block per SM at C = 256; PERF.md has both designs' times.
//
// Design: each conv is an implicit GEMM, out[co, t] = sum over (tap j,
// c_in) of W[j][c_in][co] * act(in[c_in, t + j d - pad]).  A block owns a
// BM x BN tile of (c_out, t) with BM * BN = 8192 (64 x 128 at C >= 64);
// the reduction walks taps and 8-channel slices, staging the weight slice
// (contiguous in c_out) and the shifted, activated input slice (contiguous
// in t, zero outside [0, T)) in shared memory.  Each of the 256 threads
// accumulates 4 c_out x 8 t in registers from one float4 of weights and
// two float4s of inputs per reduction step (32 FMAs per 3 shared loads).
// fp32 FMAs, no tensor cores, no cuDNN.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;  // threads per block
constexpr int BK = 8;    // input channels per reduction step
constexpr float SLOPE = 0.1f;

__device__ __forceinline__ float lrelu(float v) {
  return v >= 0.f ? v : v * SLOPE;
}

template <int BM>
__global__ void __launch_bounds__(NT)
conv_kernel(const float* __restrict__ in, const float* __restrict__ w,
            const float* __restrict__ bias, const float* __restrict__ res,
            float* __restrict__ out, float* __restrict__ acc_out, int C,
            int T, int K, int dil, int in_lrelu, int out_lrelu, int acc_mode,
            float acc_scale) {
  constexpr int BN = 8192 / BM;  // time steps per block
  constexpr int TX = BN / 8;     // threads along time
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int co0 = blockIdx.y * BM;
  const int t0 = blockIdx.x * BN;
  const int pad = (K - 1) / 2 * dil;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[i][n] = 0.f;

  for (int j = 0; j < K; ++j) {
    const int shift = t0 + j * dil - pad;
    const float* wj = w + (size_t)j * C * C + co0;
    for (int ci0 = 0; ci0 < C; ci0 += BK) {
#pragma unroll
      for (int e = tid; e < BK * BM; e += NT) {
        const int kk = e / BM, m = e % BM;
        As[kk][m] = __ldg(wj + (size_t)(ci0 + kk) * C + m);
      }
#pragma unroll
      for (int e = tid; e < BK * BN; e += NT) {
        const int kk = e / BN, n = e % BN;
        const int g = shift + n;
        float v = 0.f;
        if (g >= 0 && g < T) {
          v = __ldg(in + (size_t)(ci0 + kk) * T + g);
          if (in_lrelu) v = lrelu(v);
        }
        Bs[kk][n] = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&Bs[kk][BN / 2 + tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int n = 0; n < 8; ++n) acc[i][n] = fmaf(av[i], bv[n], acc[i][n]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int co = co0 + ty * 4 + i;
    const float bco = bias[co];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int t = t0 + (n < 4 ? tx * 4 + n : BN / 2 + tx * 4 + n - 4);
      if (t >= T) continue;
      const size_t idx = (size_t)co * T + t;
      float y = acc[i][n] + bco;
      if (out_lrelu) y = lrelu(y);
      if (res) y += res[idx];
      if (out) out[idx] = y;
      if (acc_mode == 1) acc_out[idx] = y * acc_scale;
      else if (acc_mode == 2) acc_out[idx] += y * acc_scale;
    }
  }
}

template <int BM>
int launch(const float* in, const float* w, const float* b, const float* res,
           float* out, float* acc_out, int C, int T, int K, int dil,
           int in_lrelu, int out_lrelu, int acc_mode, float acc_scale,
           cudaStream_t stream) {
  constexpr int BN = 8192 / BM;
  const dim3 grid((T + BN - 1) / BN, C / BM);
  conv_kernel<BM><<<grid, NT, 0, stream>>>(in, w, b, res, out, acc_out, C, T,
                                           K, dil, in_lrelu, out_lrelu,
                                           acc_mode, acc_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// One same-padded conv of a ResBlock1 chain on (C, T) rows:
//   y = [lrelu](conv_{K,dil}([lrelu](in)) + b) [+ res]
// stored into `out` when it is not null; acc_mode 1 stores y * acc_scale
// into acc_out, 2 adds it.  Weights are (K, C, C) laid out
// [tap][c_in][c_out].  C must be a multiple of 16.
extern "C" int resblock_conv_f32(const float* in, const float* w,
                                 const float* b, const float* res, float* out,
                                 float* acc_out, int C, int T, int K, int dil,
                                 int in_lrelu, int out_lrelu, int acc_mode,
                                 float acc_scale, cudaStream_t stream) {
  if (C % 16 != 0 || T < 1 || K < 1 || K % 2 == 0 || dil < 1)
    return (int)cudaErrorInvalidValue;
  if (C % 64 == 0)
    return launch<64>(in, w, b, res, out, acc_out, C, T, K, dil, in_lrelu,
                      out_lrelu, acc_mode, acc_scale, stream);
  if (C % 32 == 0)
    return launch<32>(in, w, b, res, out, acc_out, C, T, K, dil, in_lrelu,
                      out_lrelu, acc_mode, acc_scale, stream);
  return launch<16>(in, w, b, res, out, acc_out, C, T, K, dil, in_lrelu,
                    out_lrelu, acc_mode, acc_scale, stream);
}
