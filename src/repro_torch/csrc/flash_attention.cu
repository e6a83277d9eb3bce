// Flash attention for Hopper (sm_90a), behind a plain C ABI.
//
// Replaces the Pallas TPU kernel of the JAX reference package
//   B2  src/repro/kernels/attention/kernel.py::_flash_kernel
//       (via flash_attention_fused; layout and padding in ops.py).
//
// What it computes: softmax(q k^T * scale [softcapped], masked) v per query
// head, over the GQA layout q (B, S, Hq, D), k and v (B, T, Hkv, D), with
// Hq = Hkv * G and query head h*G + g reading KV head h.  Masks come from
// int32 positions qpos (B, S) and kpos (B, T): every kind masks kpos < 0,
// kind 0 (causal) adds kpos <= qpos, kind 1 (local) also kpos > qpos -
// window (window > 0), kind 2 (full) nothing more.  Softcap is applied
// before masking, the mask value is the finite -1e30, the exp of a masked
// lane is forced to 0, and a row whose keys are all masked writes exact
// zeros (the guarded finalize).  Math is f32; q, k, v are f32 or bf16 and
// the output has q's dtype.
//
// Design.  The TPU kernel walks the KV tiles along a sequential grid axis
// and carries the running max m, denominator l and accumulator in VMEM
// scratch (m and l replicated over 128 lanes).  Here one block owns 16
// query rows of one (batch, KV head): the GQA group rides next to the
// query rows (row = s * G + g), so one K/V tile in shared memory serves
// every query head of its KV head.  The KV axis is a loop inside the block;
// m, l and the output accumulator live in registers.  A warp owns four
// rows; in a 32-key tile each lane scores one key against those rows
// (float4 reads of the staged q rows and of its padded K row), the warp
// reduces max and sum by shuffles, and the probabilities go through shared
// memory to the P.V product, where each lane owns D/32 output dimensions.
// A tile that is masked for every row of the block (keys past the causal
// frontier, unwritten paged slots) is skipped before it is loaded; that is
// exact, because a fully masked tile leaves m, l and the accumulator as
// they were.  The ragged edge (T not a multiple of 32, S*G not a multiple
// of 16) is masked in the kernel, so nothing is padded.
//
// What bounds it.  Per admitted (query, key) pair the work is 4*D FLOPs per
// query head (score and P.V); the bytes are q, k, v and out once.  At the
// serving path's shapes decode (S=1) and paged chunks over a mostly empty
// view are bound by bytes, causal prefill by operations.  This first
// kernel runs those FLOPs on the CUDA cores in f32 (67 TFLOP/s peak), not
// on the tensor cores (989 TFLOP/s in bf16), and gives decode only
// B * Hkv blocks; wgmma, TMA and a split over the KV axis are for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows (s, g) per block
constexpr int kTile = 32;                     // keys per KV tile, one per lane
constexpr float kNegInf = -1e30f;             // finite, as in the reference
constexpr unsigned kFull = 0xffffffffu;

enum Kind { kCausal = 0, kLocal = 1, kFullMask = 2 };

struct Args {
  const void* q;         // (B, S, Hkv*G, D)
  const void* k;         // (B, T, Hkv, D)
  const void* v;         // (B, T, Hkv, D)
  const int32_t* qpos;   // (B, S)
  const int32_t* kpos;   // (B, T)
  void* out;             // (B, S, Hkv*G, D), q's dtype
  int B, S, T, Hkv, G;
  int kind, window;
  float softcap, scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ bool admitted(int kind, int window, int kp,
                                         int qp) {
  if (kp < 0) return false;
  if (kind == kFullMask) return true;
  if (kp > qp) return false;
  return kind != kLocal || window <= 0 || kp > qp - window;
}

template <int D>
constexpr size_t smem_bytes() {
  // q rows, K and V tiles (rows padded by 4 floats), probabilities, then
  // the tile's key positions and the block's query positions
  return sizeof(float) * ((size_t)kRows * D + 2 * (size_t)kTile * (D + 4) +
                          (size_t)kWarps * kRowsPerWarp * kTile) +
         sizeof(int) * (kTile + kRows);
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32) flash_kernel(Args a) {
  // K/V rows padded by 4 floats: lane j's float4 reads of row j fall in
  // distinct bank quads, and lanes reading one row's dims are contiguous
  constexpr int kLd = D + 4;
  constexpr int kDims = (D + 31) / 32;  // output dims per lane
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                                  // (kRows, D)
  float* k_s = q_s + kRows * D;                       // (kTile, kLd)
  float* v_s = k_s + kTile * kLd;                     // (kTile, kLd)
  float* p_s = v_s + kTile * kLd;                     // (kRows, kTile)
  int* kp_s = (int*)(p_s + kRows * kTile);            // (kTile,)
  int* qp_s = kp_s + kTile;                           // (kRows,)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z, h = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int n_rows = a.S * a.G;
  const int hq = a.Hkv * a.G;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);

  for (int i = tid; i < kRows * D; i += blockDim.x) {
    const int row = row0 + i / D, d = i % D;
    float x = 0.f;
    if (row < n_rows) {
      const int s = row / a.G, g = row % a.G;
      x = to_f32(q[(((long long)b * a.S + s) * hq + h * a.G + g) * D + d]);
    }
    q_s[i] = x;
  }
  if (tid < kRows) {
    const int row = row0 + tid;
    qp_s[tid] = row < n_rows ? a.qpos[(long long)b * a.S + row / a.G] : 0;
  }
  __syncthreads();

  // the block's query position range (its valid rows), for tile skipping
  int qmin = 0x7fffffff, qmax = -0x7fffffff - 1;
  for (int r = 0; r < kRows && row0 + r < n_rows; ++r) {
    qmin = min(qmin, qp_s[r]);
    qmax = max(qmax, qp_s[r]);
  }

  // this warp's rows: local rows warp, warp + 4, warp + 8, warp + 12
  int lrow[kRowsPerWarp], qp[kRowsPerWarp];
  bool live[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDims];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    lrow[i] = i * kWarps + warp;
    live[i] = row0 + lrow[i] < n_rows;
    qp[i] = qp_s[lrow[i]];
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int dd = 0; dd < kDims; ++dd) acc[i][dd] = 0.f;
  }

  for (int t0 = 0; t0 < a.T; t0 += kTile) {
    __syncthreads();  // the previous tile's shared reads are done
    int any = 0;
    if (tid < kTile) {
      const int t = t0 + tid;
      const int kp = t < a.T ? a.kpos[(long long)b * a.T + t] : -1;
      kp_s[tid] = kp;
      // admitted for some row of the block (a superset test: qmax for the
      // causal bound, qmin for the window's)
      any = kp >= 0 && (a.kind == kFullMask ||
                        (kp <= qmax && (a.kind != kLocal || a.window <= 0 ||
                                        kp > qmin - a.window)));
    }
    if (!__syncthreads_or(any)) continue;  // every pair masked: identity

    for (int i = tid; i < kTile * D; i += blockDim.x) {
      const int j = i / D, d = i % D, t = t0 + j;
      float kx = 0.f, vx = 0.f;
      if (t < a.T) {
        const long long off = (((long long)b * a.T + t) * a.Hkv + h) * D + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      k_s[j * kLd + d] = kx;
      v_s[j * kLd + d] = vx;
    }
    __syncthreads();

    // scores: lane `lane` takes key t0 + lane against the warp's rows
    float sc[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) sc[i] = 0.f;
    const float4* k4 = reinterpret_cast<const float4*>(k_s + lane * kLd);
#pragma unroll 4
    for (int d4 = 0; d4 < D / 4; ++d4) {
      const float4 kv = k4[d4];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 qv =
            reinterpret_cast<const float4*>(q_s + lrow[i] * D)[d4];
        sc[i] = fmaf(qv.x, kv.x, sc[i]);
        sc[i] = fmaf(qv.y, kv.y, sc[i]);
        sc[i] = fmaf(qv.z, kv.z, sc[i]);
        sc[i] = fmaf(qv.w, kv.w, sc[i]);
      }
    }
    const int kp = kp_s[lane];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      float* p_row = p_s + lrow[i] * kTile;
      const bool ok = live[i] && admitted(a.kind, a.window, kp, qp[i]);
      if (!__any_sync(kFull, ok)) {  // nothing admitted: the row is as it was
        p_row[lane] = 0.f;
        continue;
      }
      float x = sc[i] * a.scale;
      if (a.softcap > 0.f) x = tanhf(x / a.softcap) * a.softcap;
      x = ok ? x : kNegInf;
      const float m_new = fmaxf(m[i], warp_max(x));
      const float e = ok ? expf(x - m_new) : 0.f;  // masked lanes exactly 0
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + warp_sum(e);
      m[i] = m_new;
#pragma unroll
      for (int dd = 0; dd < kDims; ++dd) acc[i][dd] *= alpha;
      p_row[lane] = e;
    }
    __syncwarp();

    // P.V: each lane owns dims lane, lane + 32, ...
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
#pragma unroll
      for (int dd = 0; dd < kDims; ++dd) {
        const int d = lane + 32 * dd;
        if (d < D) {
          const float vv = v_s[j * kLd + d];
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i)
            acc[i][dd] = fmaf(p_s[lrow[i] * kTile + j], vv, acc[i][dd]);
        }
      }
    }
  }

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    if (!live[i]) continue;
    const int row = row0 + lrow[i], s = row / a.G, g = row % a.G;
    T* o = out + (((long long)b * a.S + s) * hq + h * a.G + g) * D;
#pragma unroll
    for (int dd = 0; dd < kDims; ++dd) {
      const int d = lane + 32 * dd;
      if (d < D)
        store(o + d, l[i] > 0.f ? acc[i][dd] / fmaxf(l[i], 1e-30f) : 0.f);
    }
  }
}

template <typename T, int D>
int launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool attr_set = false;  // per instance; setting twice is harmless
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const dim3 grid((a.S * a.G + kRows - 1) / kRows, a.Hkv, a.B);
  flash_kernel<T, D><<<grid, kWarps * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(a, stream);
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    case 256: return launch<T, 256>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// B2: flash attention.  bf16 != 0 means q, k, v and out are bf16, else
// f32.  kind: 0 causal, 1 local, 2 full.  Returns a cudaError_t value.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const int32_t* qpos, const int32_t* kpos, void* out,
                        int B, int S, int T, int Hkv, int G, int D, int bf16,
                        int kind, int window, float softcap, float scale,
                        int device, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || G <= 0) return 0;
  if (kind < kCausal || kind > kFullMask) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args a{q, k, v, qpos, kpos, out, B, S, T, Hkv, G, kind, window, softcap,
         scale};
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? dispatch<__nv_bfloat16>(a, D, s) : dispatch<float>(a, D, s);
}

}  // extern "C"
