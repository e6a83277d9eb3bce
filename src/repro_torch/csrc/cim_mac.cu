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
// The ADC rounds each array's whole sum before the next array is added.
// Rows past Rt in the last array are the zeros the reference pads with:
// they add nothing, so no kernel reads or stores them.
//
// What bounds it.  2*B*Rt*C f32 operations on one read of x, w, load and
// fs and one write of out.  At C = 1 (the KAN layer-1 MACs of the
// simulator path, 12 launches at 65536 rows) that is 2 operations per
// 4 bytes of x: the bytes bound it, and no main-path shape has a C for
// which tensor cores (wgmma, 3xTF32) would matter.  The reference's
// largest case (32 x 2048, C = 64) is a small product bound by latency.
//
// Two paths, picked by the wrapper's shape-only plan
// (kernels/cim_mac/kernel.py::mac_plan), so a row's bits never depend on B:
//
// * stream (C = 1).  Persistent blocks (as many as are resident on each
//   SM, at most 4) walk tiles of tile_rows batch rows.  A tile's rows are
//   one contiguous run of tile_rows x Rt floats; tile_rows is a multiple of
//   4, so its size and start are 16-byte multiples for any Rt, and one
//   thread brings it into a ring of kStages shared-memory stages with a
//   1-D TMA bulk copy (cp.async.bulk ... mbarrier::complete_tx); the next
//   tile's copy runs while this tile is reduced.  The ragged last tile is
//   loaded with ordinary loads.  The attenuated weights (one __fdiv_rn per r) and each
//   array's compensation, fs and lsb are staged once per block.  Each
//   (row, array) pair is reduced by a group of G lanes (8, 16 or 32, from
//   R) reading consecutive drives of the row, ended by a butterfly; the
//   pairs' sums go to shared memory and one thread per row then runs the
//   compensation, clip and ADC rounding of its arrays, in order.
// * wide (C > 1, or a C = 1 row too long to stage).  Block (32 rows x 32
//   columns, one R-chunk of 128 rows of one array) stages its x tile (drives
//   of one row on consecutive threads) and its attenuated weights
//   (consecutive columns on consecutive threads, coalesced), and each
//   thread sums 4 rows of one column over the chunk in order into an f32
//   workspace (A x chunks, B, C); a combine kernel adds an array's chunks
//   in order, applies compensation, clip and ADC, and adds the arrays in
//   order.  So the reference's (32 x 2048, C = 64) case runs on 32 blocks,
//   where one block per (row block, column tile) gave it 8.  The workspace
//   is A * chunks times the output (16x at R = 1024); the path was timed on
//   the card only at that small-B case.
//
// Host work.  The SM count and the shared-memory limits are read once per
// device and the stream kernel's dynamic shared-memory limit is set once
// per template instance and device (under one mutex); a launch then only
// checks its operands, launches and returns cudaGetLastError().
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

#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;
constexpr int kMaxBlocksPerSm = 4;
// stream path: the mbarriers' bytes ahead of the stages, and the ring's
// depth (2 stages of ~16 KB on up to 4 blocks per SM streamed faster than
// 4 or 8 deeper stages on fewer blocks; kernels/cim_mac/kernel.py mirrors it)
constexpr int kBarBytes = 128;
constexpr int kStages = 2;
// wide path tile: rows x columns x drives of one R-chunk
constexpr int kWideRows = 32;
constexpr int kWideCols = 32;
constexpr int kChunk = 128;

struct MacArgs {
  const float* x;     // (B, Rt)
  const float* w;     // (Rt, C)
  const float* load;  // (A, C)
  const float* fs;    // (A, C)
  float* out;         // (B, C)
  float* ws;          // wide path: (A * chunks, B, C)
  int B, A, R, Rt, C;
  int tile_rows;          // stream path
  int chunks;             // wide path: ceil(R / kChunk)
  float ir_scale;         // f32(ir_scale)
  float comp_scale;       // f32(ir_scale * (R + 1) / (2R))
  float levels;           // 2^adc_bits
};

__host__ __device__ inline size_t round4(size_t n) { return (n + 3) & ~(size_t)3; }

// bytes of the stream kernel's dynamic shared memory: mbarriers, stages,
// attenuated weights, per-array constants, two buffers of pair sums
__host__ __device__ inline size_t stream_smem_bytes(int rt, int a, int tile) {
  return kBarBytes + sizeof(float) * ((size_t)kStages * tile * rt + round4(rt) +
                                      round4(3 * (size_t)a) +
                                      2 * (size_t)tile * a);
}

__device__ __forceinline__ float row_dist(int r, int rows) {
  return __fdiv_rn((float)(r + 1), (float)rows);
}

// IR-drop attenuation clip(1 - ir * dist * load, 0, 1), as the reference
// rounds it
__device__ __forceinline__ float atten(float ir, float dist, float load) {
  const float f = __fsub_rn(1.f, __fmul_rn(__fmul_rn(ir, dist), load));
  return fminf(fmaxf(f, 0.f), 1.f);
}

__device__ __forceinline__ float comp_of(const MacArgs& a, float load) {
  return fmaxf(__fsub_rn(1.f, __fmul_rn(a.comp_scale, load)), 1e-3f);
}

__device__ __forceinline__ float lsb_of(const MacArgs& a, float fsv) {
  return __fdiv_rn(__fmul_rn(2.f, fsv), a.levels);
}

// compensation, clip and ADC rounding of one array's partial
__device__ __forceinline__ float adc(float p, float comp, float fsv,
                                     float lsb) {
  float q = __fdiv_rn(p, comp);
  q = fminf(fmaxf(q, -fsv), fsv);
  return __fmul_rn(rintf(__fdiv_rn(q, lsb)), lsb);
}

// ---- mbarrier and 1-D bulk copy (TMA) --------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// bytes (a multiple of 16) from 16-byte aligned global src to shared dst;
// completion is counted on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- stream path (C = 1) ----------------------------------------------------

template <int G>
__global__ void __launch_bounds__(kThreads, kMaxBlocksPerSm)
cim_mac_stream(const MacArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kGroups = kThreads / G;
  constexpr int S = kStages;
  const int T = a.tile_rows, Rt = a.Rt, R = a.R, A = a.A;
  const size_t stage_floats = (size_t)T * Rt;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* stages = reinterpret_cast<float*>(smem + kBarBytes);
  float* weff = stages + (size_t)S * stage_floats;  // (Rt)
  float* consts = weff + round4(Rt);                // comp, fs, lsb: (3, A)
  float* psum = consts + round4(3 * (size_t)A);     // (2, A, T)

  const int tid = threadIdx.x;
  const long long tiles = ((long long)a.B + T - 1) / T;
  const int mine = (int)((tiles - 1 - blockIdx.x) / gridDim.x) + 1;
  auto tile_of = [&](int j) {
    return (long long)blockIdx.x + (long long)j * gridDim.x;
  };
  auto rows_of = [&](long long t) {
    return (int)min((long long)T, (long long)a.B - t * T);
  };
  // the copy of local tile j into stage j % S; the ragged tile is left to
  // ordinary loads
  auto fetch = [&](int j) {
    const long long t = tile_of(j);
    if (rows_of(t) != T) return;
    const uint32_t bytes = (uint32_t)(stage_floats * sizeof(float));
    uint64_t* bar = bars + j % S;
    mbar_expect_tx(bar, bytes);
    bulk_load(stages + (size_t)(j % S) * stage_floats,
              a.x + t * (long long)stage_floats, bytes, bar);
  };

  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(bars + s, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int j = 0; j < min(S, mine); ++j) fetch(j);
  // once per block, while the first copies fly
  for (int r = tid; r < Rt; r += kThreads) {
    const int arr = r / R;
    weff[r] = __fmul_rn(__ldg(a.w + r), atten(a.ir_scale, row_dist(r - arr * R, R),
                                              __ldg(a.load + arr)));
  }
  for (int arr = tid; arr < A; arr += kThreads) {
    const float fsv = __ldg(a.fs + arr);
    consts[arr] = comp_of(a, __ldg(a.load + arr));
    consts[A + arr] = fsv;
    consts[2 * A + arr] = lsb_of(a, fsv);
  }
  __syncthreads();

  const int g = tid / G, gl = tid % G;
  const unsigned gbits = G == 32 ? 0xffffffffu : (1u << (G % 32)) - 1u;
  const unsigned gmask = gbits << ((tid & 31) / G * G);
  for (int j = 0; j < mine; ++j) {
    const long long t = tile_of(j);
    const int rows = rows_of(t);
    float* xt = stages + (size_t)(j % S) * stage_floats;
    if (rows == T) {
      mbar_wait(bars + j % S, (uint32_t)((j / S) & 1));
    } else {
      const float* src = a.x + t * (long long)stage_floats;
      for (int i = tid; i < rows * Rt; i += kThreads) xt[i] = __ldg(src + i);
      __syncthreads();
    }
    // pair p = (arr, row i): consecutive groups on consecutive rows of one
    // array, so their weight reads are one broadcast
    float* ps = psum + (size_t)(j & 1) * A * T;
    for (int p = g; p < rows * A; p += kGroups) {
      const int arr = p / rows, i = p - arr * rows;
      const int nr = min(R, Rt - arr * R);
      const float* xr = xt + (size_t)i * Rt + (size_t)arr * R;
      const float* wr = weff + (size_t)arr * R;
      float acc = 0.f;
#pragma unroll 4
      for (int k = gl; k < nr; k += G) acc = fmaf(xr[k], wr[k], acc);
#pragma unroll
      for (int m = G / 2; m > 0; m >>= 1)
        acc = __fadd_rn(acc, __shfl_xor_sync(gmask, acc, m));
      if (gl == 0) ps[(size_t)arr * T + i] = acc;
    }
    __syncthreads();
    // nothing reads this stage any more: refill it
    if (tid == 0 && j + S < mine) fetch(j + S);
    for (int i = tid; i < rows; i += kThreads) {
      float o = 0.f;
      for (int arr = 0; arr < A; ++arr)
        o = __fadd_rn(o, adc(ps[(size_t)arr * T + i], consts[arr],
                             consts[A + arr], consts[2 * A + arr]));
      a.out[t * T + i] = o;
    }
  }
}

// ---- wide path --------------------------------------------------------------

// one (32-row, 32-column) tile's f32 partials over one R-chunk of one array
__global__ void __launch_bounds__(kThreads) cim_mac_partial(const MacArgs a) {
  __shared__ float xs[kWideRows][kChunk];
  __shared__ float wsm[kChunk][kWideCols];
  __shared__ float dist[kChunk];
  const int arr = blockIdx.z / a.chunks, ch = blockIdx.z - arr * a.chunks;
  const int nr = min(a.R, a.Rt - arr * a.R);
  const int r0 = ch * kChunk;
  if (r0 >= nr) return;  // a chunk past the last array's real rows
  const int kr = min(kChunk, nr - r0);
  const int b0 = blockIdx.x * kWideRows, c0 = blockIdx.y * kWideCols;
  const int tid = threadIdx.x;

  if (tid < kr) dist[tid] = row_dist(r0 + tid, a.R);
  const float* xa = a.x + (size_t)arr * a.R + r0;
  for (int i = tid; i < kWideRows * kChunk; i += kThreads) {
    const int row = i / kChunk, k = i - row * kChunk;
    const int b = b0 + row;
    xs[row][k] = (b < a.B && k < kr) ? __ldg(xa + (long long)b * a.Rt + k) : 0.f;
  }
  __syncthreads();  // dist
  const int c = tid % kWideCols;
  const bool live = c0 + c < a.C;
  const float ld = live ? __ldg(a.load + (long long)arr * a.C + c0 + c) : 0.f;
  const float* wa = a.w + ((long long)arr * a.R + r0) * a.C + c0 + c;
  for (int k = tid / kWideCols; k < kr; k += kThreads / kWideCols) {
    const float v = live ? __ldg(wa + (long long)k * a.C) : 0.f;
    wsm[k][c] = __fmul_rn(v, atten(a.ir_scale, dist[k], ld));
  }
  __syncthreads();

  // thread: column c, rows rg, rg + 8, rg + 16, rg + 24; the chunk's drives
  // in order
  const int rg = tid / kWideCols;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < kr; ++k) {
    const float wv = wsm[k][c];
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] = fmaf(xs[rg + 8 * i][k], wv, acc[i]);
  }
  if (!live) return;
  float* wsz = a.ws + (long long)blockIdx.z * a.B * a.C + c0 + c;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = b0 + rg + 8 * i;
    if (b < a.B) wsz[(long long)b * a.C] = acc[i];
  }
}

// out[b, c]: per array its chunks added in order, then compensation, clip
// and ADC; the arrays added in order
__global__ void __launch_bounds__(kThreads) cim_mac_combine(const MacArgs a) {
  const long long n = (long long)a.B * a.C;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int c = (int)(i % a.C);
  float o = 0.f;
  for (int arr = 0; arr < a.A; ++arr) {
    const int nr = min(a.R, a.Rt - arr * a.R);
    const int nch = (nr + kChunk - 1) / kChunk;
    const float* p = a.ws + (long long)arr * a.chunks * n + i;
    float s = p[0];
    for (int ch = 1; ch < nch; ++ch) s = __fadd_rn(s, p[ch * n]);
    const float ld = __ldg(a.load + (long long)arr * a.C + c);
    const float fsv = __ldg(a.fs + (long long)arr * a.C + c);
    o = __fadd_rn(o, adc(s, comp_of(a, ld), fsv, lsb_of(a, fsv)));
  }
  a.out[i] = o;
}

// ---- host ---------------------------------------------------------------------

struct DeviceInfo {
  int sms = 0, max_smem = 0, smem_per_sm = 0, reserved = 0;
  cudaError_t err = cudaSuccess;
};

std::mutex g_once;  // guards the once-per-device reads and settings below

// the device's SM count and shared-memory limits, read once per device
DeviceInfo device_info(int device) {
  static DeviceInfo info[kMaxDevices];
  static bool done[kMaxDevices];
  std::lock_guard<std::mutex> lock(g_once);
  DeviceInfo& d = info[device];
  if (!done[device]) {
    done[device] = true;
    const struct {
      int* v;
      cudaDeviceAttr attr;
    } q[] = {{&d.sms, cudaDevAttrMultiProcessorCount},
             {&d.max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin},
             {&d.smem_per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor},
             {&d.reserved, cudaDevAttrReservedSharedMemoryPerBlock}};
    for (const auto& e : q) {
      d.err = cudaDeviceGetAttribute(e.v, e.attr, device);
      if (d.err != cudaSuccess) break;
    }
  }
  return d;
}

// the stream kernel's dynamic shared-memory limit raised to the opt-in
// maximum, once per template instance and device
template <int G>
cudaError_t stream_smem_attr(int device, int max_smem) {
  static cudaError_t err[kMaxDevices];
  static bool done[kMaxDevices];
  std::lock_guard<std::mutex> lock(g_once);
  if (!done[device]) {
    done[device] = true;
    err[device] = cudaFuncSetAttribute(
        cim_mac_stream<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        max_smem);
  }
  return err[device];
}

template <int G>
int launch_stream(const MacArgs& a, const DeviceInfo& d, int device,
                  cudaStream_t stream) {
  cudaError_t err = stream_smem_attr<G>(device, d.max_smem);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = stream_smem_bytes(a.Rt, a.A, a.tile_rows);
  if (smem > (size_t)d.max_smem) return (int)cudaErrorInvalidValue;
  const long long tiles = ((long long)a.B + a.tile_rows - 1) / a.tile_rows;
  // resident blocks per SM: __launch_bounds__ keeps kMaxBlocksPerSm within
  // the registers, so shared memory decides
  int per_sm = d.smem_per_sm / (int)(smem + d.reserved);
  per_sm = per_sm < 1 ? 1 : (per_sm > kMaxBlocksPerSm ? kMaxBlocksPerSm : per_sm);
  const long long fill = (long long)d.sms * per_sm;
  const unsigned blocks = (unsigned)(tiles < fill ? tiles : fill);
  cim_mac_stream<G><<<blocks, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int launch_wide(const MacArgs& a, cudaStream_t stream) {
  const dim3 grid((a.B + kWideRows - 1) / kWideRows,
                  (a.C + kWideCols - 1) / kWideCols, a.A * a.chunks);
  cim_mac_partial<<<grid, kThreads, 0, stream>>>(a);
  const long long n = (long long)a.B * a.C;
  cim_mac_combine<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                    stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// B4: the ACIM MAC of x (B, Rt) and w (Rt, C) on arrays of R rows, as the
// wrapper's plan says: tile_rows > 0 takes the stream path (C = 1, x
// 16-byte aligned, tile_rows a multiple of 4), else the wide
// path with ws of (A * chunks, B, C) floats, chunks = ceil(R / 128).
// Returns a cudaError_t value; cudaErrorInvalidValue for a plan the kernel
// does not take.
int cim_mac_fwd(const float* x, const float* w, const float* load,
                const float* fs, float* out, float* ws, int B, int Rt, int R,
                int C, int tile_rows, int chunks, float ir_scale,
                float comp_scale, int adc_bits, int device, void* stream) {
  if (B <= 0 || C <= 0 || Rt <= 0 || R <= 0) return 0;
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const DeviceInfo d = device_info(device);
  if (d.err != cudaSuccess) return (int)d.err;
  MacArgs a{x, w, load, fs, out, ws, B, (Rt + R - 1) / R, R, Rt, C,
            tile_rows, chunks, ir_scale, comp_scale, ldexpf(1.f, adc_bits)};
  cudaStream_t s = (cudaStream_t)stream;
  if (tile_rows > 0) {
    if (C != 1 || tile_rows % 4 != 0 || (uintptr_t)x % 16 != 0)
      return (int)cudaErrorInvalidValue;
    if (R <= 128) return launch_stream<8>(a, d, device, s);
    if (R <= 256) return launch_stream<16>(a, d, device, s);
    return launch_stream<32>(a, d, device, s);
  }
  if (ws == nullptr || chunks != (R + kChunk - 1) / kChunk ||
      (long long)a.A * chunks > 65535)
    return (int)cudaErrorInvalidValue;
  return launch_wide(a, s);
}

}  // extern "C"
