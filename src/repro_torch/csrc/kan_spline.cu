// Fused ASP-quantized KAN layer for Hopper (sm_90a), behind a plain C ABI.
//
// Replaces two Pallas TPU kernels of the JAX reference package:
//   B1  src/repro/kernels/kan_spline/pipeline.py::_pipeline_layer_kernel
//       (one layer of the fused multi-layer executor: optional int4-packed
//       weights / SH-LUT, raw-input residual, partial-sum noise, and the
//       fused tanh -> ASP re-coding of the next layer's int32 codes);
//   B3  src/repro/kernels/kan_spline/kernel.py::_kan_spline_kernel
//       (the single-layer form: no packing, no noise, no requantizer,
//       residual relu(deq(codes))).
// Both are one templated kernel here; the C entry points differ only in
// which optional operands they pass.
//
// What it computes, per output element (b, o):
//   y = noise[b,o]
//     + sum_f sum_{d<=K} lut[local(b,f)][d] * W[f*NB + g(b,f) + d, o]
//     + sum_f relu(resid[b,f]) * wb[f,o]
//   g = code >> LD (logical), local = code & (2^LD - 1),
//   resid = lo + code*step (or the raw f32 input),
//   W = wc, or the int4 nibbles of wcp (row 2r low, 2r+1 high, sign-
//   extended) times wscale[o];
//   optional codes_out = clip(floor((tanh(y)*hs + mid - lo')*(1/step') + .5)).
//
// Design.  The TPU kernel builds a dense (rows, F*NB) basis with a one-hot
// LUT matmul and runs the whole band through the MXU.  Only K+1 of the NB
// basis entries of a (b, f) pair are non-zero, so here the band is computed
// directly: a block stages the decoded (g, K+1 LUT values, relu residual) of
// a (kRows x kFChunk) tile of codes in shared memory, and each thread owns
// one output column and kRows accumulators, gathering the K+1 weight rows
// g..g+K of each feature.  Weight rows are read along o, so a warp's loads
// are coalesced; the SH-LUT (at most 2^LD x (K+1) f32) lives in shared
// memory, decoded from nibbles there when packed.  For G=68 (NB=71) this is
// 4/71 of the TPU's dense MAC.
//
// What bounds it.  The work a layer needs is K+2 f32 FMAs per logical
// (b, f, o).  The padded contract hands it (B, Fp) codes and writes (B, Op)
// y and codes, with Fp and Op padded to 128 at the layer boundaries.  For
// the paper's KAN layers (17->1, 1->14) the band work is tiny and those
// padded bytes at 3.35 TB/s are the bound; for the FFN stack's 64x128 and
// 128x64 layers the f32 FMA rate (67 TFLOP/s) is.  As written the kernel
// runs the band over all of Fp x Op (padded features and columns carry zero
// weights), so its time tracks the padded FMA count, not either bound.
//
// Numerics.  The requantizer and lo + code*step are written with explicit
// __fmul_rn/__fadd_rn so nvcc does not contract them into FMAs: the
// reference rounds each product and sum.  Packed and unpacked weights decode
// to the same f32 value and take the same accumulation order, so the two
// forms give bit-identical outputs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 128;   // threads per block = output columns per block
constexpr int kRows = 16;    // batch rows per block (one accumulator each)
constexpr int kFChunk = 16;  // input features staged per step

struct LayerArgs {
  const int32_t* codes;   // (B, F)
  const float* xraw;      // (B, F) or null: residual from deq(codes)
  const float* lut;       // (2^LD, KK) or null when lutp is given
  const int8_t* lutp;     // (2^LD, ceil(KK/2)) unsigned nibbles or null
  const float* wc;        // (F*NB, O) or null when wcp is given
  const int8_t* wcp;      // (F*NB/2, O) signed nibbles or null
  const float* wscale;    // (O,) with wcp
  const float* wb;        // (F, O)
  const float* noise;     // (B, O) or null
  float* y;               // (B, O)
  int32_t* codes_out;     // (B, O) or null: no requantizer
  int B, F, O, nb, ld;
  float lo, code_step, lut_scale;
  float nx_half_span, nx_mid, nx_lo, nx_scale;
  int nx_num_codes;
};

template <bool kPackedW>
__device__ __forceinline__ float load_w(const LayerArgs& a, long long row,
                                        int o, float wscale) {
  if (!kPackedW) return __ldg(a.wc + row * a.O + o);
  const int p = (int)__ldg(a.wcp + (row >> 1) * a.O + o);
  // sign-extend one nibble without left-shifting a negative int
  const int q = (row & 1) ? ((int)((unsigned)p << 24)) >> 28
                          : ((int)((unsigned)p << 28)) >> 28;
  return __fmul_rn((float)q, wscale);
}

template <bool kPackedW, int KK>
__global__ void __launch_bounds__(kCols) kan_layer_kernel(LayerArgs a) {
  extern __shared__ float s_lut[];  // (2^LD, KK)
  __shared__ int s_g[kRows][kFChunk];
  __shared__ float s_v[kRows][kFChunk][KK];
  __shared__ float s_r[kRows][kFChunk];

  const int tid = threadIdx.x;
  const int o = blockIdx.y * kCols + tid;
  const int b0 = blockIdx.x * kRows;
  const int n_local = 1 << a.ld;
  const bool col_ok = o < a.O;

  for (int i = tid; i < n_local * KK; i += kCols) {
    float v;
    if (a.lutp != nullptr) {
      const int kh = (KK + 1) / 2;
      const int u = i / KK, d = i % KK;
      const int p = (int)a.lutp[u * kh + (d >> 1)];
      const int nib = (d & 1) ? ((p >> 4) & 0xF) : (p & 0xF);
      v = __fmul_rn((float)nib, a.lut_scale);
    } else {
      v = a.lut[i];
    }
    s_lut[i] = v;
  }

  const float wscale = (kPackedW && col_ok) ? a.wscale[o] : 0.f;
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int b = b0 + r;
    acc[r] = (a.noise != nullptr && col_ok && b < a.B)
                 ? a.noise[(long long)b * a.O + o] : 0.f;
  }

  for (int f0 = 0; f0 < a.F; f0 += kFChunk) {
    __syncthreads();  // LUT written / previous chunk consumed
    for (int i = tid; i < kRows * kFChunk; i += kCols) {
      const int r = i / kFChunk, fi = i % kFChunk;
      const int b = b0 + r, f = f0 + fi;
      int g = a.nb;  // out of band: contributes nothing
      float res = 0.f;
      if (b < a.B && f < a.F) {
        const long long at = (long long)b * a.F + f;
        const int c = a.codes[at];
        const unsigned gu = (unsigned)c >> a.ld;  // logical shift
        const int local = c & (n_local - 1);
        g = gu < (unsigned)a.nb ? (int)gu : a.nb;
#pragma unroll
        for (int d = 0; d < KK; ++d) s_v[r][fi][d] = s_lut[local * KK + d];
        const float x = a.xraw != nullptr
                            ? a.xraw[at]
                            : __fadd_rn(a.lo, __fmul_rn((float)c, a.code_step));
        res = fmaxf(x, 0.f);
      }
      s_g[r][fi] = g;
      s_r[r][fi] = res;
    }
    __syncthreads();
    if (!col_ok) continue;
    const int nf = min(kFChunk, a.F - f0);
    for (int fi = 0; fi < nf; ++fi) {
      const int f = f0 + fi;
      const float wbv = __ldg(a.wb + (long long)f * a.O + o);
      const long long row0 = (long long)f * a.nb;
#pragma unroll  // acc[] stays in registers only when r is unrolled
      for (int r = 0; r < kRows; ++r) {
        const int g = s_g[r][fi];
        float s = acc[r];
#pragma unroll
        for (int d = 0; d < KK; ++d) {
          if (g + d < a.nb)
            s = fmaf(s_v[r][fi][d], load_w<kPackedW>(a, row0 + g + d, o, wscale), s);
        }
        acc[r] = fmaf(s_r[r][fi], wbv, s);
      }
    }
  }

  if (!col_ok) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int b = b0 + r;
    if (b >= a.B) break;
    const long long at = (long long)b * a.O + o;
    a.y[at] = acc[r];
    if (a.codes_out != nullptr) {
      const float h = __fadd_rn(__fmul_rn(tanhf(acc[r]), a.nx_half_span), a.nx_mid);
      const float pre = __fadd_rn(__fmul_rn(__fsub_rn(h, a.nx_lo), a.nx_scale), 0.5f);
      int q = (int)floorf(pre);
      q = q < 0 ? 0 : (q > a.nx_num_codes - 1 ? a.nx_num_codes - 1 : q);
      a.codes_out[at] = q;
    }
  }
}

template <bool kPackedW, int KK>
void launch_kk(const LayerArgs& a, cudaStream_t stream) {
  const dim3 grid((a.B + kRows - 1) / kRows, (a.O + kCols - 1) / kCols);
  const size_t smem = sizeof(float) * (size_t)(1 << a.ld) * KK;
  kan_layer_kernel<kPackedW, KK><<<grid, kCols, smem, stream>>>(a);
}

template <bool kPackedW>
int launch(const LayerArgs& a, int kk, cudaStream_t stream) {
  switch (kk) {
    case 2: launch_kk<kPackedW, 2>(a, stream); break;
    case 3: launch_kk<kPackedW, 3>(a, stream); break;
    case 4: launch_kk<kPackedW, 4>(a, stream); break;
    case 5: launch_kk<kPackedW, 5>(a, stream); break;
    case 6: launch_kk<kPackedW, 6>(a, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int run(const LayerArgs& a, int kk, int device, void* stream) {
  if (a.B <= 0 || a.O <= 0 || a.F <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((size_t)(1 << a.ld) * kk * sizeof(float) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return a.wcp != nullptr ? launch<true>(a, kk, s) : launch<false>(a, kk, s);
}

}  // namespace

extern "C" {

// B1: one fused pipeline layer.  Null pointers switch the optional operands
// off: xraw (residual from codes), lut or lutp, wc or wcp+wscale, noise,
// codes_out (last layer: no requantizer).  Returns a cudaError_t value.
int kan_pipeline_layer(const int32_t* codes, const float* xraw,
                       const float* lut, const int8_t* lutp, const float* wc,
                       const int8_t* wcp, const float* wscale, const float* wb,
                       const float* noise, float* y, int32_t* codes_out,
                       int B, int F, int O, int nb, int kk, int ld, float lo,
                       float code_step, float lut_scale, float nx_half_span,
                       float nx_mid, float nx_lo, float nx_scale,
                       int nx_num_codes, int device, void* stream) {
  LayerArgs a{codes, xraw, lut, lutp, wc, wcp, wscale, wb, noise, y,
              codes_out, B, F, O, nb, ld, lo, code_step, lut_scale,
              nx_half_span, nx_mid, nx_lo, nx_scale, nx_num_codes};
  return run(a, kk, device, stream);
}

// B3: the single-layer kan_spline (unpacked weights, deq(codes) residual).
int kan_spline_fwd(const int32_t* codes, const float* lut, const float* wc,
                   const float* wb, float* y, int B, int F, int O, int nb,
                   int kk, int ld, float lo, float code_step, int device,
                   void* stream) {
  LayerArgs a{codes, nullptr, lut, nullptr, wc, nullptr, nullptr, wb,
              nullptr, y, nullptr, B, F, O, nb, ld, lo, code_step, 0.f,
              0.f, 0.f, 0.f, 0.f, 0};
  return run(a, kk, device, stream);
}

const char* kan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
