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
//   y = sum_f ( sum_{d<=K} lut[local(b,f)][d] * W[f*NB + g(b,f) + d, o]
//              + relu(resid[b,f]) * wb[f,o] )  [+ noise[b,o]]
//   g = code >> LD (logical), local = code & (2^LD - 1),
//   resid = lo + code*step (or the raw f32 input),
//   W = wc, or the int4 nibbles of wcp (row 2r low, 2r+1 high, sign-
//   extended) times wscale[o];
//   optional codes_out = clip(floor((tanh(y)*hs + mid - lo')*(1/step') + .5)).
// The band and the residual run over the logical features f < f_log and
// columns o < o_log only (padded ones carry zero weights); padded columns
// get y = noise (or 0) and the requantized code of that y.
//
// Design.  The TPU kernel builds a dense (rows, F*NB) basis with a one-hot
// LUT matmul and runs the whole band through the MXU.  Only K+1 of the NB
// basis entries of a (b, f) pair are non-zero, so here the band is gathered
// directly, by one of two loops that give the same bits (the gather and the
// register loop, below).  The grid is (row tiles, column tiles of 128,
// feature splits); a row tile is 64 rows unless a tuned plan says
// otherwise (see "Row tile" below).  A block streams its split's features
// in chunks of kf (sized from NB so that a chunk's weight rows fit a ~24 KB
// stage: 4 for the FFN's NB = 11, 1 for KAN2's 71): for each chunk it
// copies the band's whole weight rows W[f*NB .. (f+1)*NB) and wb[f] of its
// column tile, with the chunk's codes (and raw inputs), into shared memory
// with cp.async, double
// buffered, so the copy (which does not depend on the data) streams while
// the previous chunk is computed.  int4-packed rows are decoded while they
// are staged, nibble times wscale with __fmul_rn as the unpacked bundle
// stores them, so packed and unpacked layers reach the MAC as the same f32
// values in the same order (bit-identical).  A decode pass turns each
// (row, feature) code of the chunk into its band start g, K+1 SH-LUT values
// and relu residual (g = NB, out of band, contributes nothing).  Then a
// warp owns rows (8 of a 64-row tile) and its 32 lanes own 4 columns each:
// per (row, feature) a lane reads the K+1 band rows g..g+K of its 4 columns
// as float4 from shared memory (all lanes of a warp read one row: no bank
// conflict) and does 4 FMAs per read; wb's float4 is read once per feature
// for all its rows.  A warp whose 8 rows are all in the batch runs them
// without a branch, so their loads and FMAs interleave.  (Holding a
// feature's NB band rows in registers and running the dense basis row
// against them, exact because off-band entries are 0, did 2.6x the FMAs
// and measured slower at 1024 rows.)
//
// The register loop (G = 8: every KAN-FFN half) serves the larger calls.  A
// warp reads a feature's NB = K+8 band rows of its lanes' columns into
// registers once and runs its 8 rows against them.  A row takes one of 4
// windows of K+2 band rows (starting at 0, 2, 4, 6) by a two-level branch
// on g/2; g is the same in every lane of the warp (lanes differ only in
// columns), so the branch never diverges.  The row's record holds the
// window, the relu residual and the window's K+2 coefficients: g's K+1 LUT
// values, g%2 rows in, and a zero.  A zero term leaves the sum as it is
// (the sum starts at +0, so it is never -0, and the weights are finite),
// so every output sums the gather's band terms in the gather's order.  Per
// (row, feature) it reads 2 broadcast float4s of record and 11/8 float4s of
// weights where the gather reads 6 float4s, for 24 FMAs instead of 20.  A
// warp decodes its own rows' records, so a chunk takes one barrier, not
// three, and the next row's record is read before a row's branch.  (Tried
// on the card and dropped, all with the same bits: a leaf per g, by a
// switch or a tree; 16 rows a warp; lanes that own rows, whose band reads
// then hit up to 8 rows at once; the dense basis row.)
//
// Row tile.  kRowsB, the batch rows of one block, is a template argument:
// 64 (the default, every untuned plan) or 16 or 32, picked by a tile tuner
// through PipelinePlan.row_tile (the reference's tuned batch block bb,
// clamped to 16..64); the register loop runs at 64.  The row tile and the
// loop are the knobs of the schedule that change no bit: every output
// element still sums its features in order, chunk by chunk (the chunk size
// kf depends on NB alone), and its K+1 band terms and the residual in
// order, whatever the row tile; only the staging of codes and raw inputs
// (2 * kRowsB * kf floats a stage) and the rows a warp owns (kRowsB / 8)
// change.  The launch code (pipeline.b1_loop) takes the register loop for
// G = 8 calls of 64 rows or more over 64 live columns or more, from the
// card's times of both loops (chip_smoke.py's B1 loop rows, H100: the
// gather is faster at 32 rows and below, the register loop from 64).  A
// smaller tile gives more blocks (a small batch fills more SMs) at the
// price of re-staging each weight row once per row tile.  The reference's
// other tile sizes, bo and bf, keep their meaning for padding and plan
// validation only and do not reach this kernel: its column tile is 128 and
// its feature chunks and splits depend on the layer's widths alone.
//
// Feature splits.  The split count is a function of the layer's logical
// (f, o) alone (pipeline.feature_split_plan): one split per 256 features,
// at most enough to fill the card at a single row tile (5120 -> 1280: 20
// splits x 10 column tiles; 1280 -> 5120: 5 x 40; the KAN slice's f <= 128
// layers: 1).  It never depends on the batch, so a row's y and codes depend
// only on that row's inputs: the same row at 8 and at 1024 rows gives the
// same bits.  Each split sums its features in order into a workspace
// (splits, B, O) f32 that the wrapper allocates; kan_layer_combine then
// adds the splits in split order, adds the noise operand, writes y and runs
// the requantizer.  With one split the first kernel runs that epilogue
// itself and there is no workspace.
//
// What bounds it.  The work a layer needs is K+2 f32 FMAs per logical
// (b, f, o); the bytes are the padded contract's: (B, Fp) codes (and raw
// inputs) in, (B, Op) y and codes out, and the weights once.  At the FFN
// halves (NB = 11, 288 MB of f32 weights) decode (8 rows) is bound by the
// weight bytes, 0.094 ms at 3.35 TB/s, and a 1024-row prefill bucket by
// the FMAs, 1.0 ms at 67 TFLOP/s; the KAN slice's layers at 65536 rows by
// the padded bytes or the FFN stack's FMAs, 0.290 ms for all 8.  On the
// H100 a warp's float4 read of shared memory takes about 2 SM clocks
// broadcast and 3.5 otherwise, whatever else the addresses do, so the
// count of reads per FMA binds the MAC.  At 8 rows the gather stays and
// the weight bytes bind it (0.143 ms).  At 64 rows and more the register
// loop reads 3.4 float4s and runs ~31 instructions, 24 of them FMAs, per
// (row, feature): the instruction rate and shared-memory reads bind it
// together, 3.90 ms for a 5120 x 1280 half at 1024 rows (26% of the FMA
// bound) against the gather's 4.81 (21%), which 6 reads per 20 FMAs bind.
// Not yet used: int8 weight codes (a quarter of the weight bytes) and
// tensor cores at prefill (exact integer MMAs would outrun the f32 FMA
// bound the benchmark counts B1's work against).
//
// Numerics.  The requantizer and lo + code*step are written with explicit
// __fmul_rn/__fadd_rn so nvcc does not contract them into FMAs: the
// reference rounds each product and sum.  The split merge adds with
// __fadd_rn in split order, then the noise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 128;     // output columns per block (4 per lane)
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRowsDefault = 64;  // batch rows per block, untuned
constexpr int kMaxF = 8;       // features per chunk, at most
constexpr int kStageBytes = 24 * 1024;  // weight rows of one chunk, about
constexpr int kRec = 8;        // floats of one (row, feature) record
constexpr int kRegsG = 8;      // the register loop's grid: NB = K + 8
constexpr int kRegsWin = 4;    // its windows, of kRegsG / kRegsWin band starts

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
  float* ws;              // (splits, B, O) split partials, splits > 1 only
  int B, F, O, f_log, o_log, nb, ld;
  int splits, fps, kf, vec, vec_codes;
  float lo, code_step, lut_scale;
  float nx_half_span, nx_mid, nx_lo, nx_scale;
  int nx_num_codes;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__host__ __device__ __forceinline__ constexpr int round4(int x) {
  return (x + 3) & ~3;
}

// floats of one chunk's stage: kf*NB weight rows and kf wb rows of kCols,
// then (rows, kf) codes and raw inputs
__host__ __device__ __forceinline__ int stage_floats(int kf, int nb, int rows) {
  return kf * (nb + 1) * kCols + 2 * rows * kf;
}

// y and (optionally) the next layer's code of one output element
__device__ __forceinline__ void finish(const LayerArgs& a, long long at,
                                       float yv) {
  if (a.noise != nullptr) yv = __fadd_rn(yv, a.noise[at]);
  a.y[at] = yv;
  if (a.codes_out != nullptr) {
    const float h = __fadd_rn(__fmul_rn(tanhf(yv), a.nx_half_span), a.nx_mid);
    const float pre = __fadd_rn(__fmul_rn(__fsub_rn(h, a.nx_lo), a.nx_scale), 0.5f);
    int q = (int)floorf(pre);
    q = q < 0 ? 0 : (q > a.nx_num_codes - 1 ? a.nx_num_codes - 1 : q);
    a.codes_out[at] = q;
  }
}

__device__ __forceinline__ void fma4(float v, const float4 w, float4& s) {
  s.x = fmaf(v, w.x, s.x);
  s.y = fmaf(v, w.y, s.y);
  s.z = fmaf(v, w.z, s.z);
  s.w = fmaf(v, w.w, s.w);
}

// The register loop's band: window kLo of kN, leaf by leaf.  Window wi
// holds the band rows wi*kStep .. wi*kStep + kW - 1 of the registers w[],
// the coefficients are h[2 ..]; the branches take the same side in every
// lane of the warp.
template <int kLo, int kN, int kStep, int kW, int N, int R>
__device__ __forceinline__ void win_mac(int wi, const float4 (&w)[N],
                                        const float (&h)[R], float4& s) {
  if constexpr (kN == 1) {
#pragma unroll
    for (int j = 0; j < kW; ++j) fma4(h[2 + j], w[kLo * kStep + j], s);
  } else {
    constexpr int kHalf = kN / 2;
    if (wi < kLo + kHalf)
      win_mac<kLo, kHalf, kStep, kW>(wi, w, h, s);
    else
      win_mac<kLo + kHalf, kN - kHalf, kStep, kW>(wi, w, h, s);
  }
}

// kRegs false: the gather loop; true: the register loop (G = 8)
template <bool kPackedW, int KK, int kRowsB, bool kRegs>
__global__ void __launch_bounds__(kThreads, 2) kan_layer_kernel(LayerArgs a) {
  constexpr int kRpw = kRowsB / kWarps;  // rows per warp
  constexpr int kStep = kRegsG / kRegsWin;  // band starts of a window
  constexpr int kW = kStep + KK - 1;        // band rows of a window
  constexpr int kNbr = kRegsG + KK - 1;     // band rows of a feature
  constexpr int kRecT = kRegs ? round4(2 + kW) : kRec;
  extern __shared__ __align__(16) float smem[];
  // one record per (row, feature) of the chunk, read as broadcast float4s:
  // the gather's band start g (int bits), relu residual and K+1 <= 6 LUT
  // values; the register loop's window (int bits), relu residual and the
  // window's kW coefficients
  __shared__ __align__(16) float s_rec[kRowsB][kMaxF][kRecT];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b0 = blockIdx.x * kRowsB, col0 = blockIdx.y * kCols;
  const int split = blockIdx.z;
  const int n_local = 1 << a.ld, nb = a.nb, kf = a.kf;
  const int rows = min(kRowsB, a.B - b0);
  const int ncols = min(kCols, a.o_log - col0);  // <= 0: padded tile
  const int ncols4 = round4(ncols);
  const int f_begin = split * a.fps;
  const int f_end = min(a.f_log, f_begin + a.fps);
  float* s_lut = smem;                                   // (2^LD, KK)
  float* s_stage = smem + round4(n_local * KK);          // 2 stages
  const int st_floats = stage_floats(kf, nb, kRowsB);

  for (int i = tid; i < n_local * KK; i += kThreads) {
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

  // stage chunk c (features f0 .. f0+nf) into stage st
  auto stage = [&](int c, int st) {
    float* sw = s_stage + st * st_floats;       // (kf*NB, kCols)
    float* swb = sw + kf * nb * kCols;          // (kf, kCols)
    int* scode = (int*)(swb + kf * kCols);      // (kRowsB, kf)
    float* sx = (float*)(scode + kRowsB * kf);  // (kRowsB, kf)
    const int f0 = f_begin + c * kf, nf = min(kf, f_end - f0);
    const int nrow = nf * nb;
    const long long wrow0 = (long long)f0 * nb;
    if (kPackedW) {
      for (int i = tid; i < nrow * ncols4; i += kThreads) {
        const int rr = i / ncols4, cc = i % ncols4, o = col0 + cc;
        float w = 0.f;
        if (cc < ncols) {
          const long long row = wrow0 + rr;
          const int p = (int)a.wcp[(row >> 1) * a.O + o];
          // sign-extend one nibble without left-shifting a negative int
          const int q = (row & 1) ? ((int)((unsigned)p << 24)) >> 28
                                  : ((int)((unsigned)p << 28)) >> 28;
          w = __fmul_rn((float)q, a.wscale[o]);
        }
        sw[rr * kCols + cc] = w;
      }
      for (int i = tid; i < nf * ncols4; i += kThreads) {
        const int ff = i / ncols4, cc = i % ncols4;
        swb[ff * kCols + cc] =
            cc < ncols ? a.wb[(long long)(f0 + ff) * a.O + col0 + cc] : 0.f;
      }
    } else if (a.vec) {  // 16-byte copies: O % 4 == 0, rows 16-byte aligned
      // a warp per weight row, a lane per 4 columns
      const int cc = lane * 4;
      if (cc < ncols4) {
        for (int rr = warp; rr < nrow; rr += kWarps)
          cp_async16(sw + rr * kCols + cc,
                     a.wc + (wrow0 + rr) * a.O + col0 + cc);
        for (int ff = warp; ff < nf; ff += kWarps)
          cp_async16(swb + ff * kCols + cc,
                     a.wb + (long long)(f0 + ff) * a.O + col0 + cc);
      }
    } else {
      for (int i = tid; i < nrow * ncols4; i += kThreads) {
        const int rr = i / ncols4, cc = i % ncols4;
        if (cc < ncols)
          cp_async4(sw + rr * kCols + cc, a.wc + (wrow0 + rr) * a.O + col0 + cc);
        else
          sw[rr * kCols + cc] = 0.f;
      }
      for (int i = tid; i < nf * ncols4; i += kThreads) {
        const int ff = i / ncols4, cc = i % ncols4;
        if (cc < ncols)
          cp_async4(swb + ff * kCols + cc,
                    a.wb + (long long)(f0 + ff) * a.O + col0 + cc);
        else
          swb[ff * kCols + cc] = 0.f;
      }
    }
    if (kRegs && a.vec_codes && nf == kf && (f0 & 3) == 0) {
      // 16-byte copies of 4 features of a row (kf % 4 == 0): 4% of the
      // register loop's time at 1024 rows against 4-byte ones
      const int kq = kf >> 2;
      for (int i = tid; i < rows * kq; i += kThreads) {
        const int r = i / kq, fi = (i % kq) * 4;
        const long long at = (long long)(b0 + r) * a.F + f0 + fi;
        cp_async16(scode + r * kf + fi, a.codes + at);
        if (a.xraw != nullptr) cp_async16(sx + r * kf + fi, a.xraw + at);
      }
      return;
    }
    for (int i = tid; i < rows * nf; i += kThreads) {
      const int r = i / nf, fi = i % nf;
      const long long at = (long long)(b0 + r) * a.F + f0 + fi;
      cp_async4(scode + r * kf + fi, a.codes + at);
      if (a.xraw != nullptr) cp_async4(sx + r * kf + fi, a.xraw + at);
    }
  };

  // the (row r, feature fi) record of the chunk from its code: the gather's
  // (g, relu, K+1 LUT values); the register loop's (window, relu, window
  // coefficients: g's K+1 LUT values g % kStep rows in, zeros around them;
  // a code past the grid, g = NB, leaves every coefficient 0)
  auto decode = [&](const int* scode, const float* sx, int r, int fi) {
    const int code = scode[r * kf + fi];
    const unsigned gu = (unsigned)code >> a.ld;  // logical shift
    const int local = code & (n_local - 1);
    float* rec = s_rec[r][fi];
    const int g = gu < (unsigned)nb ? (int)gu : nb;
    const float x = a.xraw != nullptr
                        ? sx[r * kf + fi]
                        : __fadd_rn(a.lo, __fmul_rn((float)code, a.code_step));
    rec[1] = fmaxf(x, 0.f);
    if (kRegs) {
      const int wi = min(g / kStep, kRegsWin - 1), sh = g - wi * kStep;
      rec[0] = __int_as_float(wi);
#pragma unroll
      for (int j = 0; j < kW; ++j)
        rec[2 + j] = j >= sh && j - sh < KK ? s_lut[local * KK + j - sh] : 0.f;
    } else {
      rec[0] = __int_as_float(g);
#pragma unroll
      for (int d = 0; d < KK; ++d) rec[2 + d] = s_lut[local * KK + d];
    }
  };

  float4 acc[kRpw];
#pragma unroll
  for (int ri = 0; ri < kRpw; ++ri) acc[ri] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int c4 = lane * 4;

  if (ncols > 0 && f_begin < f_end && rows > 0) {  // uniform over the block
    const int n_chunks = (f_end - f_begin + kf - 1) / kf;
    stage(0, 0);
    cp_commit();
    for (int c = 0; c < n_chunks; ++c) {
      if (kRegs) {
        cp_wait<0>();
        // chunk c (and the LUT) visible to every thread, and every warp
        // done with chunk c - 1, whose stage the copy of chunk c + 1 takes
        __syncthreads();
        if (c + 1 < n_chunks) stage(c + 1, (c + 1) & 1);
        cp_commit();
      } else {
        if (c + 1 < n_chunks) stage(c + 1, (c + 1) & 1);
        cp_commit();
        cp_wait<1>();
        __syncthreads();  // chunk c (and the LUT) visible to every thread
      }
      const float* sw = s_stage + (c & 1) * st_floats;
      const float* swb = sw + kf * nb * kCols;
      const int* scode = (const int*)(swb + kf * kCols);
      const float* sx = (const float*)(scode + kRowsB * kf);
      const int nf = min(kf, f_end - (f_begin + c * kf));
      if (kRegs) {
        // a warp decodes the records of its own rows, warp + 8 ri
        for (int i = lane; i < kRpw * nf; i += 32) {
          const int r = warp + kWarps * (i / nf);
          if (r < rows) decode(scode, sx, r, i % nf);
        }
        __syncwarp();
      } else {
        for (int i = tid; i < rows * nf; i += kThreads)
          decode(scode, sx, i / nf, i % nf);
        __syncthreads();
      }
      if (kRegs && c4 < ncols) {
        for (int fi = 0; fi < nf; ++fi) {
          // the feature's NB band rows of the lane's 4 columns, read once
          // for all the warp's rows
          const float* wf = sw + fi * nb * kCols + c4;
          float4 w[kNbr];
#pragma unroll
          for (int j = 0; j < kNbr; ++j)
            w[j] = *reinterpret_cast<const float4*>(wf + j * kCols);
          const float4 wbv =
              *reinterpret_cast<const float4*>(swb + fi * kCols + c4);
          // every row of the tile, also past `rows` (a stale record there
          // only fills an accumulator that is never written out); the next
          // row's record is read before this row's branch
          auto load_rec = [&](int ri, float (&h)[kRecT]) {
            const float* rp = s_rec[warp + kWarps * ri][fi];
#pragma unroll
            for (int q = 0; q < kRecT; q += 4)
              *reinterpret_cast<float4*>(h + q) =
                  *reinterpret_cast<const float4*>(rp + q);
          };
          float h[kRecT], hn[kRecT];
          load_rec(0, h);
#pragma unroll
          for (int ri = 0; ri < kRpw; ++ri) {
            if (ri + 1 < kRpw) load_rec(ri + 1, hn);
            float4 s = acc[ri];
            win_mac<0, kRegsWin, kStep, kW>(__float_as_int(h[0]), w, h, s);
            fma4(h[1], wbv, s);
            acc[ri] = s;
#pragma unroll
            for (int q = 0; q < kRecT; ++q) h[q] = hn[q];
          }
        }
      } else if (c4 < ncols) {
        for (int fi = 0; fi < nf; ++fi) {
          const float4 wbv =
              *reinterpret_cast<const float4*>(swb + fi * kCols + c4);
          const float* wf = sw + fi * nb * kCols + c4;
          auto row_mac = [&](int ri) {
            const int r = warp + kWarps * ri;
            const float4 h0 = *reinterpret_cast<const float4*>(s_rec[r][fi]);
            const float4 h1 =
                *reinterpret_cast<const float4*>(s_rec[r][fi] + 4);
            const float v[6] = {h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
            const int g = __float_as_int(h0.x);
            float4 s = acc[ri];
#pragma unroll
            for (int d = 0; d < KK; ++d) {
              if (g + d < nb)
                fma4(v[d], *reinterpret_cast<const float4*>(wf + (g + d) * kCols),
                     s);
            }
            fma4(h0.y, wbv, s);
            acc[ri] = s;
          };
          // a warp with all kRpw rows runs them without a branch, so their
          // loads and FMAs interleave (acc[] stays in registers only when
          // ri is unrolled)
          if (warp + kWarps * (kRpw - 1) < rows) {
#pragma unroll
            for (int ri = 0; ri < kRpw; ++ri) row_mac(ri);
          } else {
#pragma unroll
            for (int ri = 0; ri < kRpw; ++ri)
              if (warp + kWarps * ri < rows) row_mac(ri);
          }
        }
      }
      // the gather's stage and decode buffers are consumed
      if (!kRegs) __syncthreads();
    }
    cp_wait<0>();
  }

#pragma unroll
  for (int ri = 0; ri < kRpw; ++ri) {
    const int r = warp + kWarps * ri;
    if (r >= rows) continue;
    const float vals[4] = {acc[ri].x, acc[ri].y, acc[ri].z, acc[ri].w};
    const long long base = (long long)(b0 + r) * a.O;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = col0 + c4 + j;
      if (o >= a.O) break;
      if (a.splits == 1) {
        finish(a, base + o, o < a.o_log ? vals[j] : 0.f);
      } else if (o < a.o_log) {
        a.ws[(long long)split * a.B * a.O + base + o] = vals[j];
      }
    }
  }
}

// y = sum of the splits' partials in split order (+ noise), then the
// requantizer; one thread per (b, o), padded columns included
__global__ void __launch_bounds__(kThreads) kan_layer_combine(LayerArgs a) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long n = (long long)a.B * a.O;
  if (i >= n) return;
  float yv = 0.f;
  if ((int)(i % a.O) < a.o_log) {
    yv = a.ws[i];
    for (int sp = 1; sp < a.splits; ++sp) yv = __fadd_rn(yv, a.ws[sp * n + i]);
  }
  finish(a, i, yv);
}

template <bool kPackedW, int KK, int kRowsB, bool kRegs>
int launch_kk(const LayerArgs& a, cudaStream_t stream) {
  if (kRegs && a.nb != kRegsG + KK - 1) return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)round4((1 << a.ld) * KK) +
                       2 * (size_t)stage_floats(a.kf, a.nb, kRowsB));
  static size_t attr = 0;  // per instance: the largest size set so far
  if (smem > attr) {       // static + dynamic over 48 KB needs the opt-in
    cudaError_t err = cudaFuncSetAttribute(
        kan_layer_kernel<kPackedW, KK, kRowsB, kRegs>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr = smem;
  }
  const dim3 grid((a.B + kRowsB - 1) / kRowsB, (a.O + kCols - 1) / kCols,
                  a.splits);
  kan_layer_kernel<kPackedW, KK, kRowsB, kRegs>
      <<<grid, kThreads, smem, stream>>>(a);
  if (a.splits > 1) {
    const long long n = (long long)a.B * a.O;
    kan_layer_combine<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                        stream>>>(a);
  }
  return (int)cudaGetLastError();
}

template <bool kPackedW, int kRowsB, bool kRegs>
int launch(const LayerArgs& a, int kk, cudaStream_t stream) {
  switch (kk) {
    case 2: return launch_kk<kPackedW, 2, kRowsB, kRegs>(a, stream);
    case 3: return launch_kk<kPackedW, 3, kRowsB, kRegs>(a, stream);
    case 4: return launch_kk<kPackedW, 4, kRowsB, kRegs>(a, stream);
    case 5: return launch_kk<kPackedW, 5, kRowsB, kRegs>(a, stream);
    case 6: return launch_kk<kPackedW, 6, kRowsB, kRegs>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// loop 0: the gather at row tiles 16, 32, 64; loop 1: the register loop
// at row tile 64
template <bool kPackedW>
int launch_rows(const LayerArgs& a, int kk, int rows, int loop,
                cudaStream_t stream) {
  if (loop == 1)
    return rows == 64 ? launch<kPackedW, 64, true>(a, kk, stream)
                      : (int)cudaErrorInvalidValue;
  if (loop != 0) return (int)cudaErrorInvalidValue;
  switch (rows) {
    case 16: return launch<kPackedW, 16, false>(a, kk, stream);
    case 32: return launch<kPackedW, 32, false>(a, kk, stream);
    case 64: return launch<kPackedW, 64, false>(a, kk, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int run(LayerArgs& a, int kk, int rows, int loop, int device, void* stream) {
  if (a.B <= 0 || a.O <= 0 || a.F <= 0) return 0;
  if (a.f_log < 0 || a.f_log > a.F || a.o_log < 0 || a.o_log > a.O ||
      a.splits < 1 || a.fps < 1 || (a.splits > 1 && a.ws == nullptr) ||
      (long long)a.splits * a.fps < a.f_log)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((size_t)(1 << a.ld) * kk * sizeof(float) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  int kf = kStageBytes / ((a.nb + 1) * kCols * (int)sizeof(float));
  a.kf = kf < 1 ? 1 : (kf > kMaxF ? kMaxF : kf);
  a.vec = a.wc != nullptr && a.O % 4 == 0 &&
          (uintptr_t)a.wc % 16 == 0 && (uintptr_t)a.wb % 16 == 0;
  a.vec_codes = a.kf % 4 == 0 && a.F % 4 == 0 &&
                (uintptr_t)a.codes % 16 == 0 && (uintptr_t)a.xraw % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  return a.wcp != nullptr ? launch_rows<true>(a, kk, rows, loop, s)
                           : launch_rows<false>(a, kk, rows, loop, s);
}

}  // namespace

extern "C" {

// B1: one fused pipeline layer.  Null pointers switch the optional operands
// off: xraw (residual from codes), lut or lutp, wc or wcp+wscale, noise,
// codes_out (last layer: no requantizer).  The band runs over f < f_log and
// o < o_log; `splits` feature splits of `fps` features each (ws: (splits,
// B, O) f32 when splits > 1, else null); `loop` the band loop (0 the
// gather, 1 the register loop: G = 8 only) and `row_tile` its batch rows
// per block (16, 32 or 64; 64).  Returns a cudaError_t value, checked after
// both launches.
int kan_pipeline_layer(const int32_t* codes, const float* xraw,
                       const float* lut, const int8_t* lutp, const float* wc,
                       const int8_t* wcp, const float* wscale, const float* wb,
                       const float* noise, float* y, int32_t* codes_out,
                       float* ws, int B, int F, int O, int f_log, int o_log,
                       int nb, int kk, int ld, int splits, int fps,
                       int row_tile, int loop, float lo,
                       float code_step, float lut_scale, float nx_half_span,
                       float nx_mid, float nx_lo, float nx_scale,
                       int nx_num_codes, int device, void* stream) {
  LayerArgs a{codes, xraw, lut, lutp, wc, wcp, wscale, wb, noise, y,
              codes_out, ws, B, F, O, f_log, o_log, nb, ld, splits, fps, 0, 0,
              0, lo, code_step, lut_scale, nx_half_span, nx_mid, nx_lo, nx_scale,
              nx_num_codes};
  return run(a, kk, row_tile, loop, device, stream);
}

// B3: the single-layer kan_spline (unpacked weights, deq(codes) residual,
// unpadded: the band runs over all F and O).
int kan_spline_fwd(const int32_t* codes, const float* lut, const float* wc,
                   const float* wb, float* y, float* ws, int B, int F, int O,
                   int nb, int kk, int ld, int splits, int fps, float lo,
                   float code_step, int device, void* stream) {
  LayerArgs a{codes, nullptr, lut, nullptr, wc, nullptr, nullptr, wb,
              nullptr, y, nullptr, ws, B, F, O, F, O, nb, ld, splits, fps, 0,
              0, 0, lo, code_step, 0.f, 0.f, 0.f, 0.f, 0.f, 0};
  return run(a, kk, kRowsDefault, 0, device, stream);
}

const char* kan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
