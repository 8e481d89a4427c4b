// HiFiGAN ResBlock1 stage on Hopper's tensor cores: one conv of the chain
// per launch, 3xTF32 (fp32-accurate) through wgmma.mma_async.
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
// What bounds it on the H100.  A conv does 2 C^2 k T fp32 FLOPs against
// 8 C T bytes of activations.  Each fp32 product is three TF32 tensor-core
// products (below), so the peak is 495 / 3 = 165 TFLOP/s fp32-equivalent.
// Against 3.35 TB/s, with the 47 activation passes a stage of per-conv
// launches makes: C = 256 and 128 are bound by operations (1.9 and 4.8 ms
// of products against 0.3 and 1.4 ms of traffic for a 16 s bucket), C = 64
// still by operations (2.4 against 1.4), C = 32 by bytes (1.2 against 1.4)
// and C = 16 more so.  PERF.md has the measured times: the wgmma loop
// itself ran at 70-88% of the TF32 peak when profiled, and what is lost is
// lost around it, in the staging warps and the epilogue, which are bound
// by their own instruction latency (few warps share a scheduler here).
//
// Math: 3xTF32.  Every fp32 operand is split into hi = tf32(x), rounded to
// nearest (cvt.rna, so the low 13 mantissa bits are zero and the tensor
// core's truncation changes nothing), and lo = tf32(x - hi); the product is
// lo.hi + hi.lo + hi.hi in fp32 accumulators, small terms first.  The lo.lo
// term, about 2^-22 relative, is dropped.
//
// Design.  Instruction: wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32
// with A from registers.  The implicit GEMM is laid out for the port's
// channel-first (C, T) activations, which the TF32 wgmma cannot take as its
// 64-row operand (that would be MN-major; TF32 operands in shared memory
// are K-major only):
//   M = c_out (weights, A, registers), N = time (activations, B, shared
//   memory), K = c_in in steps of 8, once per tap.
// * Activations are staged as [c_in / 4][row][4 c_in] in 16-byte rows, hi
//   and lo images, no swizzle: an 8 x 4 core matrix of the K-major B
//   operand is then 128 contiguous bytes starting at ANY row, so a tap is
//   a row offset (16 bytes times j d) in the descriptor's start address,
//   and one staged tile of BN + 2 pad rows serves all k taps.  The
//   transpose from (C, T) happens while staging (see `produce`), and so do
//   lrelu and the split: once per staged element, not once per tap.
// * Weights never touch shared memory.  `stage_weights` lays them out in
//   the order of the wgmma A fragment, [c_in/16][tap][k8][m-tile][thread]
//   [4], so a thread fetches its fragment for one (tap, 8 c_in) step with
//   one 16-byte load from L2, one step ahead, and splits it into hi and lo
//   in registers (3 ALU instructions per value beside 192 tensor-core
//   cycles a k8 step).  Splitting in the kernel and not on the host halves
//   the weight traffic from L2, which at C = 256 (5.7 MB of hi + lo per
//   128-column tile) would otherwise ask for the whole L2 bandwidth.
// * A block is two consumer and two producer warpgroups (setmaxnreg
//   200 / 56), one block to an SM, persistent over the tiles.  Each
//   consumer holds one 64 x 128 sub-tile of the block's tile: the two are
//   two m-tiles over 128 time steps at C >= 128 (the two halves of c_out
//   are separate tiles at C = 256), or one m-tile over 256 time steps at
//   C <= 64.  The producers stage 16-channel chunks into a ring of 4-6
//   buffers, handed over with mbarriers (full / empty); a consumer's loop
//   is, per tap: load two fragments, split, six wgmmas (hi and lo, two k8
//   steps), with two taps in flight.
// * Two accumulators, for accuracy.  The tensor cores truncate when they
//   add into their fp32 accumulator, which biases a long sum towards
//   zero.  With one accumulator for a whole conv (up to 1056 wgmmas) the
//   kernel measured 3.5e-5 against the plain version at the main path's
//   shapes and missed rtol 1e-3 / atol 1e-4 where the activations grow
//   along the chain (C = 256, weights of gain 2.6 per conv).  So the
//   tensor cores sum one chunk only (at most 66 wgmmas) into `part`, and
//   the FP32 units add `part` into `acc`, rounding to nearest: 2.7e-6, the
//   fp32 FMA kernel's level.  The limit stayed; the order of the sums
//   changed.  It costs 64 registers, so a consumer holds one sub-tile, not
//   two, and a per-chunk drain of the wgmma pipeline.
// * The epilogue passes the accumulators through shared memory to read the
//   residual and write the results in whole 256-byte rows.
// * C < 64 pads c_out to the 64 rows of the instruction with zero
//   weights: half (C = 32) or three quarters (C = 16) of the products are
//   wasted there, where bytes bound the conv anyway.
// * Tiles: at C = 256, T = 19176 there are 300 tiles for 132 blocks, so
//   36 SMs do three where the others do two; the other stages have 1498
//   or 2996 tiles.
// * A stream axis.  The serving path runs the stage on N streams at once,
//   (N, C, T) contiguous with the weights shared (under `vmap` the TPU
//   kernel gets the same axis in its grid).  One launch walks N x tiles(T)
//   items; an item is (stream, tile), every activation pointer is offset
//   by stream * C * T, and the [0, T) mask is the stream's own: a halo row
//   before 0 or past T is zero, never the neighbouring stream's data.  A
//   stream's tiles, chunks and sums are those of the single-stream launch,
//   so the two agree bit for bit.  The 16-byte paths need T % 4 == 0, which
//   also keeps every stream's base aligned as the first one's is.
// fp32 FMA kernels, cuDNN and library GEMMs are not used.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int N_CONS = 256;          // two consumer warpgroups
constexpr int N_PROD = 256;          // two producer warpgroups
constexpr int NT = N_CONS + N_PROD;
constexpr int KC = 16;               // input channels per staged chunk
constexpr int MAX_PAD = 32;          // (k - 1) / 2 * dilation at most
constexpr float SLOPE = 0.1f;
constexpr int EP_STRIDE = 72;        // floats per row of the epilogue buffer:
                                     // 8 mod 32, so float2 stores of a
                                     // fragment hit every bank once

// A block's tile is two 64 x 128 sub-tiles, one per consumer warpgroup:
// two m-tiles over 128 time steps (C >= 128; at C = 256 the two halves of
// c_out are separate tiles) or one m-tile over 256 time steps (C <= 64).
template <int C>
struct Cfg {
  static constexpr int M = C < 64 ? 64 : C;     // c_out padded to 64 rows
  static constexpr int MT = M / 64;             // 64-row m-tiles
  static constexpr int NA = MT >= 2 ? 2 : 1;    // m-tiles of one block
  static constexpr int MH = MT / NA;            // blocks along c_out
  static constexpr int BN = 256 / NA;           // time steps per block
  static constexpr int R = BN + 2 * MAX_PAD;    // staged rows per channel group
  static constexpr int IMG = (KC / 4) * R * 16; // bytes of one hi or lo image
  static constexpr int STAGE = 2 * IMG;
  static constexpr int S = NA == 2 ? 6 : 4;     // ring depth
  static constexpr int NCH = C / KC;
  static constexpr int EP = S * STAGE + 128;    // epilogue buffers, after the
                                                // ring and its barriers
  static constexpr int EP_BYTES = 64 * EP_STRIDE * 4;  // per consumer
  static constexpr int SMEM = EP + 2 * EP_BYTES;
};

__device__ __forceinline__ float lrelu(float v) {
  return v >= 0.f ? v : v * SLOPE;
}

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" ::"r"(bar)
      : "memory");
}

// Blocks until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// K-major, no swizzle: 8 x 16-byte core matrices of 128 contiguous bytes;
// `lbo` is the byte distance between core matrices along K, `sbo` along N.
__device__ __forceinline__ uint64_t desc_strides(uint32_t lbo, uint32_t sbo) {
  return ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}
__device__ __forceinline__ uint64_t desc_at(uint64_t strides, uint32_t addr) {
  return strides | (uint64_t)((addr & 0x3FFFF) >> 4);
}

// d (64 x 128 fp32, in the warpgroup's registers) += a (64 x 8 TF32,
// registers) . b (8 x 128 TF32, shared memory through `desc`).
// With `accumulate` 0 the old d is ignored (d = a . b).
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t desc,
                                                int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

// Transpose a 4 x 4 block held by four neighbouring lanes (lane b of the
// four holds row b): afterwards lane b holds column b.
__device__ __forceinline__ void transpose4(float4& x, int b) {
  const bool b0 = b & 1, b1 = b & 2;
  float s0 = b0 ? x.x : x.y, s1 = b0 ? x.z : x.w;
  float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
  float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
  if (b0) {
    x.x = r0;
    x.z = r1;
  } else {
    x.y = r0;
    x.w = r1;
  }
  s0 = b1 ? x.x : x.z;
  s1 = b1 ? x.y : x.w;
  r0 = __shfl_xor_sync(0xffffffffu, s0, 2);
  r1 = __shfl_xor_sync(0xffffffffu, s1, 2);
  if (b1) {
    x.x = r0;
    x.y = r1;
  } else {
    x.z = r0;
    x.w = r1;
  }
}

// Activate, split and store one 16-byte row (4 channels at one time step)
// of the hi image and of the lo image.
__device__ __forceinline__ void store_row(uint8_t* dst, int img,
                                          const float (&v)[4], int in_lrelu) {
  uint32_t vh[4], vl[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    tf32_split(in_lrelu ? lrelu(v[e]) : v[e], vh[e], vl[e]);
  *reinterpret_cast<uint4*>(dst) = make_uint4(vh[0], vh[1], vh[2], vh[3]);
  *reinterpret_cast<uint4*>(dst + img) = make_uint4(vl[0], vl[1], vl[2], vl[3]);
}

constexpr int QUADS = N_PROD / 4;  // lane quads of the producers

// N units of the vector path for one lane quad: unit un + QUADS j is time
// quad q of channel group grp; lane b of the four loads channel 4 grp + b,
// and after the transpose stores row 4 q + b.  All N loads are asked for
// before the first is used.
template <int C, int N>
__device__ __forceinline__ void stage_quads(const float* __restrict__ src,
                                            uint8_t* hi, int T, int t_start,
                                            int nq, int units, int un0, int b,
                                            int in_lrelu) {
  using G = Cfg<C>;
  float4 x[N];
  int grp[N], q[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int un = un0 + QUADS * j;
    grp[j] = (un >= nq) + (un >= 2 * nq) + (un >= 3 * nq);
    q[j] = un - grp[j] * nq;
    const int t = t_start + 4 * q[j];
    x[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (un < units && t >= 0 && t < T)
      x[j] = __ldg(reinterpret_cast<const float4*>(
          src + (size_t)(4 * grp[j] + b) * T + t));
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    transpose4(x[j], b);
    if (un0 + QUADS * j < units) {
      const float v[4] = {x[j].x, x[j].y, x[j].z, x[j].w};
      store_row(hi + (grp[j] * G::R + 4 * q[j] + b) * 16, G::IMG, v, in_lrelu);
    }
  }
}

// The producer warpgroups: for each of the block's tiles, stage chunk after
// chunk of 16 input channels, activated, split and transposed.  Row r of a
// chunk is time step t0 - pad4 + r, pad4 = pad rounded up to 4, so that
// with T a multiple of 4 every staged quad of time steps is one aligned
// 16-byte load, wholly inside or outside [0, T).  Four lanes load four
// channels' quads and transpose them among themselves, so that each lane
// stores one 16-byte row and eight lanes eight consecutive rows (no bank
// conflict); a thread keeps four such loads in flight.  Other T take
// 4-byte loads, 8 in flight.
template <int C>
__device__ __forceinline__ void produce(const float* __restrict__ in,
                                        uint8_t* smem, uint32_t full,
                                        uint32_t empty, int T, int nitems,
                                        int per_stream, int pad4,
                                        int in_lrelu) {
  using G = Cfg<C>;
  constexpr int U = 4;
  const int p = threadIdx.x - N_CONS;
  const int rows = G::BN + 2 * pad4;
  const bool vec =
      (T & 3) == 0 && (reinterpret_cast<uintptr_t>(in) & 15) == 0;
  const int b = p & 3, u = p >> 2;
  const int nq = rows >> 2, units = (KC / 4) * nq;
  // (units is a multiple of 8, and a warp's eight lane quads take eight
  // neighbouring units, so whole warps take every turn of the loops below)
  int it = 0;  // chunks staged so far: ring slot it % S, round it / S
  for (int item = blockIdx.x; item < nitems; item += gridDim.x) {
    const int sb = item / per_stream;  // the item's stream and tile
    const int t_start = ((item - sb * per_stream) / G::MH) * G::BN - pad4;
    const float* in_s = in + (size_t)sb * C * T;
    for (int ch = 0; ch < G::NCH; ++ch, ++it) {
      const int s = it % G::S;
      mbar_wait(empty + 8 * s, ((it / G::S) & 1) ^ 1);
      uint8_t* hi = smem + s * G::STAGE;
      const float* src = in_s + (size_t)ch * KC * T;
      if (vec) {
        int un = u;  // this lane quad's next unit: (channel group, quad)
        for (; un + QUADS * (U - 1) < units; un += QUADS * U)
          stage_quads<C, U>(src, hi, T, t_start, nq, units, un, b, in_lrelu);
        for (; un < units; un += QUADS * 2)
          stage_quads<C, 2>(src, hi, T, t_start, nq, units, un, b, in_lrelu);
      } else {
        for (int row = p; row < rows; row += N_PROD) {
          const int t = t_start + row;
          const bool ok = t >= 0 && t < T;
#pragma unroll
          for (int g = 0; g < KC / 4; g += 2) {
            float v[2][4];
#pragma unroll
            for (int e = 0; e < 8; ++e)
              v[e >> 2][e & 3] =
                  ok ? __ldg(src + (size_t)(4 * g + e) * T + t) : 0.f;
#pragma unroll
            for (int h = 0; h < 2; ++h)
              store_row(hi + ((g + h) * G::R + row) * 16, G::IMG, v[h],
                        in_lrelu);
          }
        }
      }
      // generic-proxy stores must be visible to wgmma's async-proxy reads
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(full + 8 * s);
    }
  }
}

// The second half of the epilogue, for one warp: 16 rows (c_out m0 ..)
// by 64 columns (time t0 ..) of y, staged in `ep`.  Adds the residual,
// stores y and/or y * acc_scale into (acc_mode 1) or onto (2) the stage
// output.  Half a warp takes a row, a lane four columns; the residual and
// the stage output of four row pairs are asked for before any is used.
template <int C>
__device__ __forceinline__ void finish_rows(const float* ep, int m0, int t0,
                                            int lane, int T,
                                            const float* __restrict__ res,
                                            float* __restrict__ out,
                                            float* __restrict__ acc_out,
                                            int acc_mode, float acc_scale,
                                            bool vec) {
  const int rsel = lane >> 4, c4 = 4 * (lane & 15);
  const int t = t0 + c4;
  if (vec) {  // T a multiple of 4 and so is t: four columns in or out
#pragma unroll 1
    for (int i0 = 0; i0 < 8; i0 += 4) {
      float4 r[4], prev[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = 2 * (i0 + j) + rsel;
        const size_t idx = (size_t)(m0 + row) * T + t;
        const bool ok = m0 + row < C && t < T;
        r[j] = prev[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (res && ok) r[j] = __ldg(reinterpret_cast<const float4*>(res + idx));
        if (acc_mode == 2 && ok)
          prev[j] = *reinterpret_cast<const float4*>(acc_out + idx);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = 2 * (i0 + j) + rsel;
        if (m0 + row >= C || t >= T) continue;
        const size_t idx = (size_t)(m0 + row) * T + t;
        float4 y = *reinterpret_cast<const float4*>(ep + row * EP_STRIDE + c4);
        y.x += r[j].x;
        y.y += r[j].y;
        y.z += r[j].z;
        y.w += r[j].w;
        if (out) *reinterpret_cast<float4*>(out + idx) = y;
        if (acc_mode)
          *reinterpret_cast<float4*>(acc_out + idx) = make_float4(
              fmaf(y.x, acc_scale, prev[j].x), fmaf(y.y, acc_scale, prev[j].y),
              fmaf(y.z, acc_scale, prev[j].z), fmaf(y.w, acc_scale, prev[j].w));
      }
    }
  } else {
#pragma unroll 1
    for (int i = 0; i < 8; ++i) {
      const int row = 2 * i + rsel;
      if (m0 + row >= C) continue;
#pragma unroll 1
      for (int e = 0; e < 4; ++e) {
        if (t + e >= T) break;
        const size_t idx = (size_t)(m0 + row) * T + t + e;
        float y = ep[row * EP_STRIDE + c4 + e];
        if (res) y += res[idx];
        if (out) out[idx] = y;
        if (acc_mode == 1) acc_out[idx] = y * acc_scale;
        else if (acc_mode == 2) acc_out[idx] += y * acc_scale;
      }
    }
  }
}

template <int C>
__global__ void __launch_bounds__(NT, 1)
conv_kernel(const float* __restrict__ in, const float4* __restrict__ wp,
            const float* __restrict__ bias, const float* __restrict__ res,
            float* __restrict__ out, float* __restrict__ acc_out, int NB,
            int T, int K, int dil, int in_lrelu, int out_lrelu, int acc_mode,
            float acc_scale) {
  using G = Cfg<C>;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t full = smem_u32(smem + G::S * G::STAGE);
  const uint32_t empty = full + 8 * G::S;
  const int per_stream = (T + G::BN - 1) / G::BN * G::MH;
  const int nitems = NB * per_stream;
  const int pad = (K - 1) / 2 * dil;
  const int pad4 = (pad + 3) & ~3;  // staged rows start at t0 - pad4

  if (threadIdx.x == 0) {
    for (int s = 0; s < G::S; ++s) {
      mbar_init(full + 8 * s, N_PROD);
      mbar_init(empty + 8 * s, N_CONS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= N_CONS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    produce<C>(in, smem, full, empty, T, nitems, per_stream, pad4, in_lrelu);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 200;\n");
    const int wg = threadIdx.x >> 7;  // this warpgroup's sub-tile
    const int t128 = threadIdx.x & 127;
    const int warp = t128 >> 5, lane = t128 & 31;
    const int noff = G::NA == 2 ? 0 : 128 * wg;  // its columns in the tile
    const uint64_t strides = desc_strides(G::R * 16, 128);
    const uint32_t smem0 = smem_u32(smem);
    const float4* wq = wp + t128;
    const int steps = G::NCH * K * 2;
    const bool vec =
        (T & 3) == 0 && ((reinterpret_cast<uintptr_t>(res) |
                          reinterpret_cast<uintptr_t>(out) |
                          reinterpret_cast<uintptr_t>(acc_out)) & 15) == 0;
    float* ep = reinterpret_cast<float*>(smem + G::EP + wg * G::EP_BYTES);
    int it = 0;  // chunks consumed so far, as in the producer
    // `part` is one chunk's sum (16 input channels, all taps), added up by
    // the tensor cores; `acc` is the sum of the chunks, added up by the
    // FP32 units, which round to nearest (see the header).
    float acc[64], part[64];
    // Two sets of fragments of one tap (two k8 steps) each: while the
    // wgmmas of one tap run, the next tap's weights are split into the other.
    uint32_t ah[2][2][4], al[2][2][4];

    for (int item = blockIdx.x; item < nitems; item += gridDim.x) {
      const int tile = item % per_stream;  // within the item's stream
      const int t0 = (tile / G::MH) * G::BN;
      const int mt = G::NA == 2 ? 2 * (tile % G::MH) + wg : 0;  // its m-tile
      // the biases of this thread's two accumulator rows, asked for now and
      // used in the epilogue
      float bco[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int co = 64 * mt + 16 * warp + (lane >> 2) + 8 * h;
        bco[h] = co < C ? __ldg(bias + co) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      float4 raw[2];  // the next tap's weights, as they come from L2
#pragma unroll
      for (int k8 = 0; k8 < 2; ++k8)
        raw[k8] = __ldg(wq + ((size_t)k8 * G::MT + mt) * 128);
      int step = 0;

      for (int ch = 0; ch < G::NCH; ++ch, ++it) {
        const int s = it % G::S;
        mbar_wait(full + 8 * s, (it / G::S) & 1);
        const uint32_t stage = smem0 + s * G::STAGE;
        // One tap (two k8 steps, six wgmmas) is one group; the fragment
        // sets alternate with the tap, so the loop is unrolled by two.
        auto tap_group = [&](auto set, int tap) {
          constexpr int P = decltype(set)::value;
          // at most the previous tap is in flight: set P is free again
          wgmma_wait1();
#pragma unroll
          for (int k8 = 0; k8 < 2; ++k8) {
            tf32_split(raw[k8].x, ah[P][k8][0], al[P][k8][0]);
            tf32_split(raw[k8].y, ah[P][k8][1], al[P][k8][1]);
            tf32_split(raw[k8].z, ah[P][k8][2], al[P][k8][2]);
            tf32_split(raw[k8].w, ah[P][k8][3], al[P][k8][3]);
          }
          step += 2;
          if (step < steps) {
#pragma unroll
            for (int k8 = 0; k8 < 2; ++k8)
              raw[k8] = __ldg(wq + ((size_t)(step + k8) * G::MT + mt) * 128);
          }
          wgmma_fence();
#pragma unroll
          for (int k8 = 0; k8 < 2; ++k8) {
            const uint32_t addr =
                stage + ((2 * k8) * G::R + noff + tap * dil + pad4 - pad) * 16;
            const uint64_t b_hi = desc_at(strides, addr);
            const uint64_t b_lo = desc_at(strides, addr + G::IMG);
            wgmma_m64n128k8(part, al[P][k8], b_hi, tap + k8 > 0);
            wgmma_m64n128k8(part, ah[P][k8], b_lo, 1);
            wgmma_m64n128k8(part, ah[P][k8], b_hi, 1);
          }
          wgmma_commit();
        };
        for (int tap = 0; tap < K; tap += 2) {
          tap_group(std::integral_constant<int, 0>{}, tap);
          if (tap + 1 < K) tap_group(std::integral_constant<int, 1>{}, tap + 1);
        }
        wgmma_wait0();
        mbar_arrive(empty + 8 * s);  // the chunk is read
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += part[i];
      }

      // Epilogue.  Accumulator 4 nb + 2 h + c is row 16 warp + lane / 4 +
      // 8 h, column 8 nb + 2 (lane % 4) + c: 32-byte pieces of 8 rows per
      // warp instruction.  So each warp passes its 16 rows through shared
      // memory, 64 columns at a time, with the bias and the activation
      // applied, and `finish_rows` takes them from there in whole 256-byte
      // rows.  The pointers move to the item's stream here.
      const size_t soff = (size_t)(item / per_stream) * C * T;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* dst = ep + (16 * warp + (lane >> 2) + 8 * h) * EP_STRIDE +
                       2 * (lane & 3);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int nb = 8 * half + i;
            float y0 = acc[4 * nb + 2 * h] + bco[h];
            float y1 = acc[4 * nb + 2 * h + 1] + bco[h];
            if (out_lrelu) {
              y0 = lrelu(y0);
              y1 = lrelu(y1);
            }
            *reinterpret_cast<float2*>(dst + 8 * i) = make_float2(y0, y1);
          }
        }
        __syncwarp();
        finish_rows<C>(ep + 16 * warp * EP_STRIDE, 64 * mt + 16 * warp,
                       t0 + noff + 64 * half, lane, T,
                       res ? res + soff : nullptr, out ? out + soff : nullptr,
                       acc_out ? acc_out + soff : nullptr, acc_mode,
                       acc_scale, vec);
        __syncwarp();
      }
    }  // items
  }
}

template <int C>
int launch(const float* in, const float* wp, const float* b, const float* res,
           float* out, float* acc_out, int N, int T, int K, int dil,
           int in_lrelu, int out_lrelu, int acc_mode, float acc_scale,
           cudaStream_t stream) {
  using G = Cfg<C>;
  cudaError_t err = cudaFuncSetAttribute(
      conv_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return (int)err;
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  // persistent: one block per SM walks the items blockIdx.x, + gridDim.x, ...
  // of all the streams
  const long long nitems = (long long)N * ((T + G::BN - 1) / G::BN * G::MH);
  if (nitems > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  conv_kernel<C><<<nitems < n_sm ? (int)nitems : n_sm, NT, G::SMEM, stream>>>(
      in, reinterpret_cast<const float4*>(wp), b, res, out, acc_out, N, T, K,
      dil, in_lrelu, out_lrelu, acc_mode, acc_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// One same-padded conv of a ResBlock1 chain on N streams of (C, T) rows,
// (N, C, T) contiguous, each padded on its own length:
//   y = [lrelu](conv_{K,dil}([lrelu](in)) + b) [+ res]
// stored into `out` when it is not null; acc_mode 1 stores y * acc_scale
// into acc_out, 2 adds it.  `wp` holds the (K, C, C) weights in fragment
// order (ops/kernels/resblock.py, pack_conv_weight).  The library is built
// once per width, -DRESBLOCK_C=16, 32, 64, 128 or 256, so that the widths
// compile side by side; (K - 1) / 2 * dil is at most 32.
#ifndef RESBLOCK_C
#error "compile with -DRESBLOCK_C=<channels>: 16, 32, 64, 128 or 256"
#endif
extern "C" int resblock_conv_3xtf32(const float* in, const float* wp,
                                    const float* b, const float* res,
                                    float* out, float* acc_out, int N, int C,
                                    int T, int K, int dil, int in_lrelu,
                                    int out_lrelu, int acc_mode,
                                    float acc_scale, cudaStream_t stream) {
  if (N < 1 || C != RESBLOCK_C || T < 1 || K < 1 || K % 2 == 0 || dil < 1 ||
      (K - 1) / 2 * dil > MAX_PAD)
    return (int)cudaErrorInvalidValue;
  return launch<RESBLOCK_C>(in, wp, b, res, out, acc_out, N, T, K, dil,
                            in_lrelu, out_lrelu, acc_mode, acc_scale, stream);
}
