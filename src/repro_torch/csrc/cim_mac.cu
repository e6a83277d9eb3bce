// ACIM simulator MAC for Hopper (sm_90a), behind a plain C ABI.
//
// Replaces the Pallas TPU kernel of the JAX reference package
//   B4  src/repro/kernels/cim_mac/kernel.py::_cim_mac_kernel
//       (via cim_mac_pallas; entry point kernels/cim_mac/ops.py::cim_mac).
//
// What it computes, on x (B, Rt) and w (Rt, C), whose Rt rows fill
// A = ceil(Rt / R) arrays of R rows (the last one ragged), and load and
// fs (A, C), all f32:
//   per array a:  f[r,c]  = clip(1 - ir * ((r+1)/R) * load[a,c], 0, 1)
//                 p[b,c]  = sum_r x[b,aR+r] * (w[aR+r,c] * f[r,c])
//                 p      /= max(1 - ir_mean * load[a,c], 1e-3)
//                 p       = rint(clip(p, -fs, fs) / lsb) * lsb,  lsb = 2 fs / 2^adc
//   out[b,c] = sum over a = 0..A-1, in that order, of p.
// R is one physical array's rows: its sum is the analog summation, so it
// is never split; the ADC rounds each array's sum before the next is added.
// Rows past Rt in the last array are the zeros the reference pads with:
// they add nothing, so the kernel neither reads nor stores them.
//
// Design.  The TPU kernel walks the arrays as the sequential grid axis with
// MXU-aligned (128-wide) batch and column tiles, carrying the output tile in
// VMEM.  Here one block owns rows_per_block batch rows x kC columns (kC =
// 1, 8 or 32, picked from C) and loops over the arrays itself.  Per array
// the block stages the IR-drop-attenuated weights w*f of its columns in
// shared memory (column-major, so lanes reading consecutive rows hit
// distinct banks); each warp then takes whole batch rows: its lanes stride
// the array's R rows with coalesced x loads, keep one partial per column,
// reduce them with a shuffle butterfly, and lane c applies compensation,
// clip and ADC rounding for column c and adds the result to the row's
// accumulator in shared memory.  Nothing is padded: ragged B, C and the
// last array's rows are masked here, so the paper's layer-1 MACs (C = 1,
// Rt = 136 or 1207 on arrays of 128 or 1024) do no dead work, where the
// TPU wrapper pads that column to 128 and the rows to whole arrays.
//
// What bounds it.  2*B*Rt*C f32 operations and one read of x, w, load and
// fs and one write of out.  With C = 1 (the KAN layer-1 MACs) x dominates
// and the bytes bound it; at C = 64 (the largest reference case) it is a
// small f32 product bound by operations.  x is read once; w, load and fs
// once per row block.
//
// Numerics.  The factor, the compensation and the ADC step are written with
// explicit __fmul_rn / __fsub_rn / __fdiv_rn so nvcc contracts nothing into
// an FMA and divides exactly, as the reference rounds each op; rintf rounds
// half to even like jnp.round.  What is left to differ from the reference
// is the order of the f32 sum inside one array, which can move a partial
// across an ADC rounding boundary (one LSB of that array).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRowsPerBlock = 64;

struct MacArgs {
  const float* x;     // (B, Rt)
  const float* w;     // (Rt, C)
  const float* load;  // (A, C)
  const float* fs;    // (A, C)
  float* out;         // (B, C)
  int B, A, R, Rt, C;
  int rows_per_block;
  float ir_scale;     // f32(ir_scale)
  float comp_scale;   // f32(ir_scale * (R + 1) / (2R))
  float levels;       // 2^adc_bits
};

template <int kC>
__global__ void __launch_bounds__(kThreads)
cim_mac_kernel(const MacArgs a) {
  extern __shared__ float smem[];
  float* weff = smem;              // (kC, R): weff[c * R + r]
  float* acc = smem + kC * a.R;    // (rows_per_block, kC)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b0 = blockIdx.x * a.rows_per_block;
  const int c0 = blockIdx.y * kC;
  const int nrows = min(a.rows_per_block, a.B - b0);
  const int ncols = min(kC, a.C - c0);
  const float rows_f = (float)a.R;

  for (int i = tid; i < a.rows_per_block * kC; i += kThreads) acc[i] = 0.f;

  for (int arr = 0; arr < a.A; ++arr) {
    __syncthreads();  // the previous array's weff is no longer read
    const int nr = min(a.R, a.Rt - arr * a.R);  // the array's real rows
    const float* w_a = a.w + (long long)arr * a.R * a.C + c0;
    const float* load_a = a.load + (long long)arr * a.C + c0;
    for (int i = tid; i < kC * nr; i += kThreads) {
      const int c = i / nr, r = i - c * nr;
      float v = 0.f;
      if (c < ncols) {
        const float dist = __fdiv_rn((float)(r + 1), rows_f);
        float f = __fsub_rn(1.f, __fmul_rn(__fmul_rn(a.ir_scale, dist),
                                           __ldg(load_a + c)));
        f = fminf(fmaxf(f, 0.f), 1.f);
        v = __fmul_rn(__ldg(w_a + (long long)r * a.C + c), f);
      }
      weff[c * a.R + r] = v;
    }
    __syncthreads();

    // lane c's column constants for this array
    float comp = 1.f, fsv = 0.f, lsb = 1.f;
    if (lane < ncols) {
      fsv = __ldg(a.fs + (long long)arr * a.C + c0 + lane);
      comp = fmaxf(__fsub_rn(1.f, __fmul_rn(a.comp_scale, __ldg(load_a + lane))),
                   1e-3f);
      lsb = __fdiv_rn(__fmul_rn(2.f, fsv), a.levels);
    }
    for (int i = warp; i < nrows; i += kWarps) {
      const float* xr =
          a.x + (long long)(b0 + i) * a.Rt + (long long)arr * a.R;
      float p[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) p[c] = 0.f;
#pragma unroll 4
      for (int r = lane; r < nr; r += 32) {
        const float xv = __ldg(xr + r);
#pragma unroll
        for (int c = 0; c < kC; ++c) p[c] = fmaf(xv, weff[c * a.R + r], p[c]);
      }
      // butterfly: every lane ends with the same sum of each column
#pragma unroll
      for (int c = 0; c < kC; ++c) {
#pragma unroll
        for (int m = 16; m > 0; m >>= 1)
          p[c] = __fadd_rn(p[c], __shfl_xor_sync(0xffffffffu, p[c], m));
      }
      float mine = p[0];
#pragma unroll
      for (int c = 1; c < kC; ++c)
        if (lane == c) mine = p[c];
      if (lane < ncols) {
        float q = __fdiv_rn(mine, comp);
        q = fminf(fmaxf(q, -fsv), fsv);
        q = __fmul_rn(rintf(__fdiv_rn(q, lsb)), lsb);
        acc[i * kC + lane] = __fadd_rn(acc[i * kC + lane], q);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < nrows * kC; i += kThreads) {
    const int row = i / kC, c = i - row * kC;
    if (c < ncols) a.out[(long long)(b0 + row) * a.C + c0 + c] = acc[i];
  }
}

size_t smem_bytes(int kc, int R, int rows_per_block) {
  return sizeof(float) * ((size_t)kc * R + (size_t)rows_per_block * kc);
}

template <int kC>
int launch(MacArgs a, int sms, int max_smem, cudaStream_t stream) {
  const int col_tiles = (a.C + kC - 1) / kC;
  // fewer rows per block while the grid would not cover two waves of SMs
  int rpb = kMaxRowsPerBlock;
  while (rpb > kWarps &&
         (long long)((a.B + rpb - 1) / rpb) * col_tiles < 2LL * sms)
    rpb /= 2;
  while (rpb > kWarps && smem_bytes(kC, a.R, rpb) > (size_t)max_smem)
    rpb /= 2;
  a.rows_per_block = rpb;
  const size_t smem = smem_bytes(kC, a.R, rpb);
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        cim_mac_kernel<kC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((a.B + rpb - 1) / rpb, col_tiles);
  cim_mac_kernel<kC><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// B4: the ACIM MAC of x (B, Rt) and w (Rt, C) on arrays of R rows.
// Returns a cudaError_t value; cudaErrorInvalidValue when one array's
// staged weights exceed shared memory even at one column per block.
int cim_mac_fwd(const float* x, const float* w, const float* load,
                const float* fs, float* out, int B, int Rt, int R, int C,
                float ir_scale, float comp_scale, int adc_bits, int device,
                void* stream) {
  if (B <= 0 || C <= 0 || Rt <= 0 || R <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0, max_smem = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  MacArgs a{x, w, load, fs, out, B, (Rt + R - 1) / R, R, Rt, C, 0,
            ir_scale, comp_scale, ldexpf(1.f, adc_bits)};
  cudaStream_t s = (cudaStream_t)stream;
  // widest column tile that C needs and one array's weights fit
  int kc = C == 1 ? 1 : (C <= 8 ? 8 : 32);
  while (kc > 1 && smem_bytes(kc, R, kWarps) > (size_t)max_smem)
    kc = kc == 32 ? 8 : 1;
  switch (kc) {
    case 1: return launch<1>(a, sms, max_smem, s);
    case 8: return launch<8>(a, sms, max_smem, s);
    default: return launch<32>(a, sms, max_smem, s);
  }
}

}  // extern "C"
