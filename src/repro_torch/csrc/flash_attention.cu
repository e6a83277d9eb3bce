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
// scratch.  Here a block owns a run of (query, group) rows of one (batch,
// KV head): the GQA group rides next to the query rows (row = s * G + g),
// so one K/V tile in shared memory serves every query head of its KV head,
// and the causal mask is taken per row from that row's query position.
// Two instances:
//
//  * bf16 operands at D = 64, 128 or 256 (every bf16 call of the serving
//    paths) run on the tensor cores (flash_kernel_mma).  A block owns 64
//    rows: 4 warps of 16.  K/V tiles of 64 keys (32 at D = 256, below) are
//    staged with cp.async, double-buffered, rows padded by 16 bytes so
//    ldmatrix reads hit distinct banks.  S = Q.K^T is mma.sync.m16n8k16
//    bf16 -> f32 (ldmatrix fragments; V through ldmatrix.trans); scale,
//    softcap, mask and the online softmax run in f32 on the accumulator
//    fragments (in the log2 domain, exp2f), with quad shuffles for the row
//    max and a per-thread partial of the row sum.  A tile whose every key
//    is admitted for every row of the block (the interior of a causal
//    prefill) skips the mask.  P.V keeps P at f32 precision: each
//    probability is split into hi = bf16(p) and lo = bf16(p - hi), and
//    P.V = hi.V + lo.V is two bf16 MMAs into f32.  Rounding P to bf16
//    alone (as FlashAttention and SDPA do) puts about 2^-9 * sum(p |v|)
//    into every output, several bf16 ulps of an output near zero at
//    T ~ 1000; the hi/lo split leaves about 2^-17, so the kernel holds the
//    card check's one-ulp bf16 gate.  The denominator is summed from the
//    f32 p.  A warp whose 16 rows all lie past S*G (a decode block at
//    G = 16 has one live warp of four) still stages tiles and votes, but
//    skips its MMAs and softmax.
//
//    At D = 256 (recurrentgemma's local layers, G = 16) a warp's 16 x 256
//    f32 output fragments are 128 registers a thread; a 64-key score tile
//    would add 32 more, so the instance takes 32-key tiles (16).  That
//    also halves the staged K/V: Q 33.8 KB + 2 stages of K and V 67.6 KB,
//    about 101.9 KB, so two blocks (8 warps) share an SM, where 64-key
//    tiles (169.7 KB) would leave one.  ptxas must report no spill for
//    flash_kernel_mma<256> (chip_smoke.py checks it).
//  * f32 operands (and bf16 at D = 16 / 32) keep the CUDA-core kernel
//    (flash_kernel): TF32 is off by rule, so f32 has no exact tensor-core
//    path.  One block owns 16 rows; a warp owns four; in a 32-key tile each
//    lane scores one key (float4 reads of the staged rows), the warp reduces
//    max and sum by shuffles, and P goes through shared memory to P.V.
//
// Split KV axis.  When B * Hkv * ceil(S*G/64) blocks leave the card
// under-filled (decode: 4 * 8 * 1 = 32 blocks on 132 SMs; verify, S = k+1;
// recurrentgemma's decode: 4 * 1 * 1 = 4) the wrapper picks a split count
// from the call's shapes alone (never from the data) and the tensor-core
// kernel splits the KV tiles over blocks.
// Each split writes its unnormalised (m, l, acc) to a workspace the wrapper
// allocates; flash_kernel_combine then merges the splits of each row in
// split order (deterministic): M = max m_s, w_s = exp(m_s - M) where
// l_s > 0 and 0 where it is not, out = sum w_s acc_s / sum w_s l_s, or
// exact zeros when no split admitted a key.  A split whose tiles are all
// masked writes m = -1e30, l = 0 and contributes nothing.  The splits cut
// at whole tiles of the instance (ref.py::mma_block_k mirrors kKeys).
//
// Both kernels skip a tile that is masked for every row of the block (keys
// past the causal frontier or outside the window, unwritten paged slots)
// before loading it; that is exact, because a fully masked tile leaves m, l
// and the accumulator as they were.  The ragged edges (T not a multiple of
// the tile, S*G not a multiple of the block's rows) are masked in the
// kernel; staged K/V rows past T are zero-filled, so nothing is padded.
//
// What bounds it.  Per admitted (query, key) pair the work is 4*D FLOPs per
// query head (score and P.V); the bytes are q, k, v and out once.  At the
// serving path's shapes (PERF.md) decode (4 x 1 x 1024) is bound by bytes,
// 0.0050 ms; causal prefill (1000 x 1000) by operations, 0.0124 ms at the
// bf16 tensor-core peak; the paged chunk (256 over a 1024-key view) by
// operations, 0.0041 ms; recurrentgemma's windowed prefill (2300 x 2300,
// D = 256, window 2048) by operations, 0.0433 ms, and its ring decode
// (4 x 1 x 2048) by bytes, 0.0025 ms.  The hi/lo split adds a third to the
// MMAs.  Not yet used: wgmma, TMA and a persistent schedule.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

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
  float* ws_o;           // (splits, B, Hkv, S*G, D) partial accumulators
  float* ws_ml;          // (splits, B, Hkv, S*G, 2) partial (m, l)
  int B, S, T, Hkv, G;
  int kind, window, splits;
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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: mma.sync.m16n8k16, cp.async double buffering
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 4;
constexpr int kTcRows = 16 * kTcWarps;  // (query, group) rows per block

template <int D>
struct TcShape {
  // keys per KV tile: 64, or 32 at D = 256 (registers and shared memory,
  // see the header); ref.py::mma_block_k gives the same
  static constexpr int kKeys = D > 128 ? 32 : 64;
  static constexpr int kLd = D + 8;  // bf16 per staged row: 16 B of padding
  static constexpr int kQ = kTcRows * kLd;
  static constexpr int kKV = kKeys * kLd;
  static constexpr size_t kBytes =
      sizeof(bf16) * (size_t)(kQ + 4 * kKV) +
      sizeof(int) * (size_t)(2 * kKeys + kTcRows);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; zero-filled (nothing read) when !full
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

// p = hi + lo to about 2^-17 relative: hi = bf16(p), lo = bf16(p - hi)
// (p - hi is exact in f32); x is the lower-k element of the pair
__device__ __forceinline__ void split_hi_lo(float x, float y, uint32_t& hi,
                                            uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

template <int D>
__global__ void __launch_bounds__(kTcWarps * 32)
    flash_kernel_mma(Args a) {
  using Sh = TcShape<D>;
  constexpr int kLd = Sh::kLd;
  constexpr int kKeys = Sh::kKeys;
  constexpr int kChunks = D / 8;     // 16-byte chunks of one staged row
  constexpr int kNT = kKeys / 8;     // 8-key score tiles of a warp's rows
  constexpr int kDT = D / 8;         // 8-dim output tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // (kTcRows, kLd)
  bf16* k_s = q_s + Sh::kQ;                        // 2 x (kKeys, kLd)
  bf16* v_s = k_s + 2 * Sh::kKV;                   // 2 x (kKeys, kLd)
  int* kp_s = reinterpret_cast<int*>(v_s + 2 * Sh::kKV);  // 2 x kKeys
  int* qp_s = kp_s + 2 * kKeys;                            // kTcRows

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.z % a.splits, b = blockIdx.z / a.splits;
  const int h = blockIdx.y;
  const int row0 = blockIdx.x * kTcRows;
  const int n_rows = a.S * a.G;
  const int hq = a.Hkv * a.G;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);

  for (int i = tid; i < kTcRows * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = i % kChunks, row = row0 + r;
    const bf16* src = q;
    if (row < n_rows) {
      const int s = row / a.G, g = row % a.G;
      src = q + (((long long)b * a.S + s) * hq + h * a.G + g) * D + c * 8;
    }
    cp_async16(q_s + r * kLd + c * 8, src, row < n_rows);
  }
  if (tid < kTcRows) {
    const int row = row0 + tid;
    qp_s[tid] = row < n_rows ? a.qpos[(long long)b * a.S + row / a.G] : 0;
  }
  __syncthreads();
  int qmin = 0x7fffffff, qmax = -0x7fffffff - 1;
  for (int r = 0; r < kTcRows && row0 + r < n_rows; ++r) {
    qmin = min(qmin, qp_s[r]);
    qmax = max(qmax, qp_s[r]);
  }

  // this split's KV tiles
  const int n_tiles = (a.T + kKeys - 1) / kKeys;
  const int per = (n_tiles + a.splits - 1) / a.splits;
  const int t_begin = min(n_tiles, split * per);
  const int t_end = min(n_tiles, t_begin + per);

  // the next tile at or after `tile` admitted for some row of the block
  // (a superset test, as in flash_kernel); threads < kKeys keep its key
  // positions in `kp`, and `full` says whether every key of it is admitted
  // for every row of the block (then the tile needs no mask).  Every thread
  // takes part (block-wide votes).
  auto next_live = [&](int tile, int& kp, bool& full) {
    for (; tile < t_end; ++tile) {
      int any = 0, all = 1;
      kp = -1;
      if (tid < kKeys) {
        const int t = tile * kKeys + tid;
        kp = t < a.T ? a.kpos[(long long)b * a.T + t] : -1;
        any = kp >= 0 && (a.kind == kFullMask ||
                          (kp <= qmax && (a.kind != kLocal || a.window <= 0 ||
                                          kp > qmin - a.window)));
        all = kp >= 0 && (a.kind == kFullMask ||
                          (kp <= qmin && (a.kind != kLocal || a.window <= 0 ||
                                          kp > qmax - a.window)));
      }
      if (__syncthreads_or(any)) {
        full = __syncthreads_and(all) != 0;
        return tile;
      }
    }
    return t_end;
  };
  auto load_tile = [&](int tile, int st, int kp) {
    bf16* ks = k_s + st * Sh::kKV;
    bf16* vs = v_s + st * Sh::kKV;
    for (int i = tid; i < kKeys * kChunks; i += blockDim.x) {
      const int j = i / kChunks, c = i % kChunks, t = tile * kKeys + j;
      const long long off =
          t < a.T ? (((long long)b * a.T + t) * a.Hkv + h) * D + c * 8 : 0;
      cp_async16(ks + j * kLd + c * 8, k + off, t < a.T);
      cp_async16(vs + j * kLd + c * 8, v + off, t < a.T);
    }
    if (tid < kKeys) kp_s[st * kKeys + tid] = kp;
  };

  // this thread's fragment rows: local rows lr and lr + 8 of its warp
  const int lr = warp * 16 + (lane >> 2);
  const bool live[2] = {row0 + lr < n_rows, row0 + lr + 8 < n_rows};
  const bool warp_live = row0 + warp * 16 < n_rows;
  const int qp[2] = {qp_s[lr], qp_s[lr + 8]};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
    o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;

  int kp;
  bool full = false, full_nxt = false;
  int cur = next_live(t_begin, kp, full);
  if (cur < t_end) load_tile(cur, 0, kp);
  cp_commit();  // Q and the first tile
  int st = 0;
  // scores go to the log2 domain (exp2f): scale * log2(e) folded in
  constexpr float kLog2e = 1.4426950408889634f;
  const float scale2 = a.scale * kLog2e;
  while (cur < t_end) {
    const int nxt = next_live(cur + 1, kp, full_nxt);
    if (nxt < t_end) load_tile(nxt, st ^ 1, kp);
    cp_commit();
    cp_wait<1>();  // everything but the tile just issued has landed
    __syncthreads();
    const bf16* ks = k_s + st * Sh::kKV;
    const bf16* vs = v_s + st * Sh::kKV;
    const int* kps = kp_s + st * kKeys;

    // a warp with no live row skips the math (its rows are never stored)
    if (warp_live) {
      // S = Q K^T for this warp's 16 rows x kKeys keys
      float s[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t af[4];
        ldsm_x4(af, q_s + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd
                        + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < kNT; j += 2) {
          uint32_t bf[4];
          ldsm_x4(bf, ks + (j * 8 + (lane & 7) + (lane >> 4) * 8) * kLd
                          + kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(s[j], af, bf[0], bf[1]);
          mma_bf16(s[j + 1], af, bf[2], bf[3]);
        }
      }

      // scale, softcap, mask (element e: row half e >> 1, key j*8 + 2*(lane&3)
      // + (e&1)), then the online softmax per row half, in the log2 domain.
      // A tile admitted for every row of the block skips the mask; rows past
      // S*G then score zero-filled queries and are never stored.
      uint32_t ok_bits = 0xffffffffu;
      if (!full) {
        ok_bits = 0;
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const int2 kp2 =
              *reinterpret_cast<const int2*>(kps + j * 8 + (lane & 3) * 2);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rh = e >> 1;
            const int kpe = (e & 1) ? kp2.y : kp2.x;
            const bool ok =
                live[rh] && admitted(a.kind, a.window, kpe, qp[rh]);
            ok_bits |= (uint32_t)ok << (j * 4 + e);
          }
        }
      }
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x;
          if (a.softcap > 0.f)
            x = tanhf(s[j][e] * a.scale / a.softcap) * a.softcap * kLog2e;
          else
            x = s[j][e] * scale2;
          x = (ok_bits >> (j * 4 + e)) & 1u ? x : kNegInf;
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const float m_new = fmaxf(m[rh], quad_max(mx[rh]));
        alpha[rh] = exp2f(m[rh] - m_new);
        m[rh] = m_new;
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rh = e >> 1;
          // masked lanes exactly 0, never exp(-1e30 - m)
          const float p = (ok_bits >> (j * 4 + e)) & 1u
                              ? exp2f(s[j][e] - m[rh]) : 0.f;
          s[j][e] = p;
          sum[rh] += p;
        }
      }
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) l[rh] = l[rh] * alpha[rh] + sum[rh];
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        o[dt][0] *= alpha[0];
        o[dt][1] *= alpha[0];
        o[dt][2] *= alpha[1];
        o[dt][3] *= alpha[1];
      }

      // O += P V with P = hi + lo, two bf16 MMAs per fragment
#pragma unroll
      for (int j2 = 0; j2 < kKeys / 16; ++j2) {
        uint32_t hi[4], lo[4];
        split_hi_lo(s[2 * j2][0], s[2 * j2][1], hi[0], lo[0]);
        split_hi_lo(s[2 * j2][2], s[2 * j2][3], hi[1], lo[1]);
        split_hi_lo(s[2 * j2 + 1][0], s[2 * j2 + 1][1], hi[2], lo[2]);
        split_hi_lo(s[2 * j2 + 1][2], s[2 * j2 + 1][3], hi[3], lo[3]);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t bf[4];
          ldsm_x4_t(bf, vs + (j2 * 16 + (lane & 7) + ((lane >> 3) & 1) * 8)
                                 * kLd + dp * 16 + (lane >> 4) * 8);
          mma_bf16(o[2 * dp], hi, bf[0], bf[1]);
          mma_bf16(o[2 * dp], lo, bf[0], bf[1]);
          mma_bf16(o[2 * dp + 1], hi, bf[2], bf[3]);
          mma_bf16(o[2 * dp + 1], lo, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // this stage's reads are done before it is refilled
    st ^= 1;
    cur = nxt;
    full = full_nxt;
  }
  cp_wait<0>();

#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const float lsum = quad_sum(l[rh]);
    if (!live[rh]) continue;
    const int row = row0 + lr + 8 * rh;
    if (a.splits == 1) {
      const int s_ = row / a.G, g_ = row % a.G;
      bf16* out = static_cast<bf16*>(a.out) +
                  (((long long)b * a.S + s_) * hq + h * a.G + g_) * D;
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        const int d = dt * 8 + (lane & 3) * 2;
        const float x0 = lsum > 0.f ? o[dt][2 * rh] / fmaxf(lsum, 1e-30f) : 0.f;
        const float x1 =
            lsum > 0.f ? o[dt][2 * rh + 1] / fmaxf(lsum, 1e-30f) : 0.f;
        *reinterpret_cast<__nv_bfloat162*>(out + d) =
            __floats2bfloat162_rn(x0, x1);
      }
    } else {
      const long long at =
          (((long long)split * a.B + b) * a.Hkv + h) * n_rows + row;
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        const int d = dt * 8 + (lane & 3) * 2;
        *reinterpret_cast<float2*>(a.ws_o + at * D + d) =
            make_float2(o[dt][2 * rh], o[dt][2 * rh + 1]);
      }
      if ((lane & 3) == 0) {
        a.ws_ml[at * 2] = m[rh];
        a.ws_ml[at * 2 + 1] = lsum;
      }
    }
  }
}

// The latent (MLA) decode instance: rows = (query, head) pairs of one
// batch, all reading ONE latent KV head of DQK bf16 values a position (the
// normed latent c, then the shared rotary key), whose first DV values are
// also the value.  A block owns 16 rows (one m16 fragment, every head of
// one decode query) and all 4 warps share them: per 32-key tile each warp
// scores 8 keys over DQK, the row maxima and sums meet in shared memory,
// the tile's probabilities go through shared memory (f32) to P.V, and each
// warp accumulates DV / 4 of the output dims (P = hi + lo, as
// flash_kernel_mma).  Every staged row is read once a block, and tiles
// past the block's last query position are never loaded, so a slot's cache
// is read up to its real length.  Keys are the cache's slot indices;
// key t is admitted for a row at position qp when t <= qp and t < T.  The
// output is f32.
template <int DQK>
struct MlaShape {
  static constexpr int kRows = 16;
  static constexpr int kKeys = 32;
  static constexpr int kLd = DQK + 8;    // bf16 per staged row
  static constexpr int kPLd = kKeys + 8;  // f32 per probability row
  static constexpr size_t kBytes =
      sizeof(bf16) * (size_t)(kRows * kLd + 2 * kKeys * kLd) +
      sizeof(float) * (size_t)(kRows * kPLd + 2 * kTcWarps * kRows) +
      sizeof(int) * kRows;
};

template <int DQK, int DV>
__global__ void __launch_bounds__(kTcWarps * 32)
    flash_kernel_mla(Args a) {
  using Sh = MlaShape<DQK>;
  constexpr int kRows = Sh::kRows, kKeys = Sh::kKeys, kLd = Sh::kLd;
  constexpr int kPLd = Sh::kPLd;
  constexpr int kChunks = DQK / 8;   // 16-byte chunks of one staged row
  constexpr int kDW = DV / kTcWarps;  // output dims of one warp
  constexpr int kDT = kDW / 8;        // its 8-dim output tiles
  static_assert(DQK % 32 == 0 && kDW % 16 == 0 && kKeys == 8 * kTcWarps,
                "a warp scores 8 keys and owns whole 16-dim slices");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // (kRows, kLd)
  bf16* kv_s = q_s + kRows * kLd;                   // 2 x (kKeys, kLd)
  float* p_s = reinterpret_cast<float*>(kv_s + 2 * kKeys * kLd);  // probs
  float* mx_s = p_s + kRows * kPLd;                 // (warps, kRows) maxima
  float* sm_s = mx_s + kTcWarps * kRows;            // (warps, kRows) sums
  int* qp_s = reinterpret_cast<int*>(sm_s + kTcWarps * kRows);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.z % a.splits, b = blockIdx.z / a.splits;
  const int row0 = blockIdx.x * kRows;
  const int n_rows = a.S * a.G;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* kv = static_cast<const bf16*>(a.k);

  for (int i = tid; i < kRows * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = i % kChunks, row = row0 + r;
    const bf16* src =
        row < n_rows ? q + ((long long)b * n_rows + row) * DQK + c * 8 : q;
    cp_async16(q_s + r * kLd + c * 8, src, row < n_rows);
  }
  if (tid < kRows) {
    const int row = row0 + tid;
    qp_s[tid] = row < n_rows ? a.qpos[(long long)b * a.S + row / a.G] : -1;
  }
  __syncthreads();
  int qmax = -1;
  for (int r = 0; r < kRows; ++r) qmax = max(qmax, qp_s[r]);

  // the live tiles (keys 0 .. min(T, qmax + 1) - 1), cut into whole-tile
  // runs, one a split
  const int live_keys = min(a.T, qmax + 1);
  const int n_tiles = live_keys > 0 ? (live_keys + kKeys - 1) / kKeys : 0;
  const int per = (n_tiles + a.splits - 1) / a.splits;
  const int t_begin = min(n_tiles, split * per);
  const int t_end = min(n_tiles, t_begin + per);

  auto load_tile = [&](int tile, int st) {
    bf16* dst = kv_s + st * kKeys * kLd;
    for (int i = tid; i < kKeys * kChunks; i += blockDim.x) {
      const int j = i / kChunks, c = i % kChunks, t = tile * kKeys + j;
      const long long off = t < a.T ? ((long long)b * a.T + t) * DQK + c * 8
                                    : 0;
      cp_async16(dst + j * kLd + c * 8, kv + off, t < a.T);
    }
  };

  // this thread's fragment rows lr and lr + 8, its keys 2 * (lane & 3) +
  // {0, 1} of its warp's 8
  const int lr = lane >> 2, kq = 2 * (lane & 3);
  const int qp[2] = {qp_s[lr], qp_s[lr + 8]};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
    o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;

  int cur = t_begin;
  if (cur < t_end) load_tile(cur, 0);
  cp_commit();  // Q and the first tile
  int st = 0;
  constexpr float kLog2e = 1.4426950408889634f;
  const float scale2 = a.scale * kLog2e;
  while (cur < t_end) {
    if (cur + 1 < t_end) load_tile(cur + 1, st ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const bf16* ks = kv_s + st * kKeys * kLd;

    // S = Q K^T: 16 rows x this warp's 8 keys, two k-steps a round
    float s4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 6
    for (int kk = 0; kk < DQK / 16; kk += 2) {
      uint32_t a0[4], a1[4], bf[4];
      const bf16* qa =
          q_s + ((lane & 7) + ((lane >> 3) & 1) * 8) * kLd + kk * 16 +
          (lane >> 4) * 8;
      ldsm_x4(a0, qa);
      ldsm_x4(a1, qa + 16);
      ldsm_x4(bf, ks + (warp * 8 + (lane & 7)) * kLd + kk * 16 +
                      ((lane >> 3) & 1) * 8 + (lane >> 4) * 16);
      mma_bf16(s4, a0, bf[0], bf[1]);
      mma_bf16(s4, a1, bf[2], bf[3]);
    }

    // scale and mask (element e: row half e >> 1, key kq + (e & 1)), the
    // warp's row maxima to shared memory
    const int t0 = cur * kKeys + warp * 8 + kq;
    bool ok[4];
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = t0 + (e & 1);
      ok[e] = t < a.T && t <= qp[e >> 1];
      s4[e] = ok[e] ? s4[e] * scale2 : kNegInf;
      mx[e >> 1] = fmaxf(mx[e >> 1], s4[e]);
    }
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
    if ((lane & 3) == 0) {
      mx_s[warp * kRows + lr] = mx[0];
      mx_s[warp * kRows + lr + 8] = mx[1];
    }
    __syncthreads();

    // the tile's maxima over every warp (the same in each), the
    // probabilities to shared memory, the warp's row sums
    float alpha[2], sum[2];
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      float tm = kNegInf;
#pragma unroll
      for (int w = 0; w < kTcWarps; ++w)
        tm = fmaxf(tm, mx_s[w * kRows + lr + 8 * rh]);
      const float m_new = fmaxf(m[rh], tm);
      alpha[rh] = exp2f(m[rh] - m_new);
      m[rh] = m_new;
      // masked lanes exactly 0, never exp(-1e30 - m)
      const float p0 = ok[2 * rh] ? exp2f(s4[2 * rh] - m_new) : 0.f;
      const float p1 = ok[2 * rh + 1] ? exp2f(s4[2 * rh + 1] - m_new) : 0.f;
      *reinterpret_cast<float2*>(p_s + (lr + 8 * rh) * kPLd + warp * 8 + kq) =
          make_float2(p0, p1);
      sum[rh] = quad_sum(p0 + p1);
    }
    if ((lane & 3) == 0) {
      sm_s[warp * kRows + lr] = sum[0];
      sm_s[warp * kRows + lr + 8] = sum[1];
    }
    __syncthreads();
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      float ts = 0.f;
#pragma unroll
      for (int w = 0; w < kTcWarps; ++w) ts += sm_s[w * kRows + lr + 8 * rh];
      l[rh] = l[rh] * alpha[rh] + ts;
    }
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }

    // O += P V over this warp's kDW dims, P = hi + lo
#pragma unroll
    for (int j2 = 0; j2 < kKeys / 16; ++j2) {
      const float* pr = p_s + lr * kPLd + j2 * 16 + kq;
      const float2 x0 = *reinterpret_cast<const float2*>(pr);
      const float2 x1 = *reinterpret_cast<const float2*>(pr + 8 * kPLd);
      const float2 x2 = *reinterpret_cast<const float2*>(pr + 8);
      const float2 x3 = *reinterpret_cast<const float2*>(pr + 8 * kPLd + 8);
      uint32_t hi[4], lo[4];
      split_hi_lo(x0.x, x0.y, hi[0], lo[0]);
      split_hi_lo(x1.x, x1.y, hi[1], lo[1]);
      split_hi_lo(x2.x, x2.y, hi[2], lo[2]);
      split_hi_lo(x3.x, x3.y, hi[3], lo[3]);
#pragma unroll
      for (int dp = 0; dp < kDW / 16; ++dp) {
        uint32_t bf[4];
        ldsm_x4_t(bf, ks + (j2 * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               kLd + warp * kDW + dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], hi, bf[0], bf[1]);
        mma_bf16(o[2 * dp], lo, bf[0], bf[1]);
        mma_bf16(o[2 * dp + 1], hi, bf[2], bf[3]);
        mma_bf16(o[2 * dp + 1], lo, bf[2], bf[3]);
      }
    }
    __syncthreads();  // this stage, the maxima, sums and probabilities are
                      // read before the next tile writes them
    st ^= 1;
    ++cur;
  }
  cp_wait<0>();

#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int row = row0 + lr + 8 * rh;
    if (row >= n_rows) continue;
    if (a.splits == 1) {
      float* out = static_cast<float*>(a.out) +
                   ((long long)b * n_rows + row) * DV + warp * kDW;
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        const float x0 = l[rh] > 0.f ? o[dt][2 * rh] / l[rh] : 0.f;
        const float x1 = l[rh] > 0.f ? o[dt][2 * rh + 1] / l[rh] : 0.f;
        *reinterpret_cast<float2*>(out + dt * 8 + kq) = make_float2(x0, x1);
      }
    } else {
      const long long at = ((long long)split * a.B + b) * n_rows + row;
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt)
        *reinterpret_cast<float2*>(a.ws_o + at * DV + warp * kDW + dt * 8 +
                                   kq) =
            make_float2(o[dt][2 * rh], o[dt][2 * rh + 1]);
      if (warp == 0 && (lane & 3) == 0) {
        a.ws_ml[at * 2] = m[rh];
        a.ws_ml[at * 2 + 1] = l[rh];
      }
    }
  }
}

// Merge the KV splits of each (b, h, row) in split order; one thread per
// output dim.  m is in the log2 domain, as flash_kernel_mma keeps it.  A
// split with l = 0 (every key masked) gets weight 0 even when its m equals
// the maximum (both -1e30).
template <int D, typename TO = bf16>
__global__ void __launch_bounds__(D) flash_kernel_combine(Args a) {
  const int row = blockIdx.x, h = blockIdx.y, b = blockIdx.z, d = threadIdx.x;
  const int n_rows = a.S * a.G;
  const long long slice = (long long)a.B * a.Hkv * n_rows;
  const long long at = ((long long)b * a.Hkv + h) * n_rows + row;
  float mmax = kNegInf;
  for (int sp = 0; sp < a.splits; ++sp)
    mmax = fmaxf(mmax, a.ws_ml[(sp * slice + at) * 2]);
  float lsum = 0.f, acc = 0.f;
  for (int sp = 0; sp < a.splits; ++sp) {
    const long long i = sp * slice + at;
    const float ls = a.ws_ml[i * 2 + 1];
    const float w = ls > 0.f ? exp2f(a.ws_ml[i * 2] - mmax) : 0.f;
    lsum = __fadd_rn(lsum, __fmul_rn(ls, w));
    acc = __fadd_rn(acc, __fmul_rn(a.ws_o[i * D + d], w));
  }
  const int s_ = row / a.G, g_ = row % a.G;
  TO* out = static_cast<TO*>(a.out) +
            (((long long)b * a.S + s_) * a.Hkv * a.G + h * a.G + g_) * D;
  store(out + d, lsum > 0.f ? acc / fmaxf(lsum, 1e-30f) : 0.f);
}

template <int D>
int launch_mma(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = TcShape<D>::kBytes;
  static bool attr_set = false;  // per instance; setting twice is harmless
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int n_rows = a.S * a.G;
  const dim3 grid((n_rows + kTcRows - 1) / kTcRows, a.Hkv, a.B * a.splits);
  flash_kernel_mma<D><<<grid, kTcWarps * 32, smem, stream>>>(a);
  if (a.splits > 1) {
    flash_kernel_combine<D><<<dim3(n_rows, a.Hkv, a.B), D, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

template <int DQK, int DV>
int launch_mla(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = MlaShape<DQK>::kBytes;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel_mla<DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int n_rows = a.S * a.G;
  constexpr int kRows = MlaShape<DQK>::kRows;
  const dim3 grid((n_rows + kRows - 1) / kRows, 1, a.B * a.splits);
  flash_kernel_mla<DQK, DV><<<grid, kTcWarps * 32, smem, stream>>>(a);
  if (a.splits > 1) {
    flash_kernel_combine<DV, float><<<dim3(n_rows, 1, a.B), DV, 0, stream>>>(
        a);
  }
  return (int)cudaGetLastError();
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

// the CUDA-core instance: f32 at every head dim, bf16 at D = 16 and 32
// (bf16 at 64 / 128 / 256 goes to launch_mma and never reaches it)
template <typename T>
int dispatch(const Args& a, int d, cudaStream_t stream) {
  if (a.splits != 1) return (int)cudaErrorInvalidValue;  // mma instance only
  switch (d) {
    case 16: return launch<T, 16>(a, stream);
    case 32: return launch<T, 32>(a, stream);
  }
  if constexpr (std::is_same<T, float>::value) {
    switch (d) {
      case 64: return launch<T, 64>(a, stream);
      case 128: return launch<T, 128>(a, stream);
      case 256: return launch<T, 256>(a, stream);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// B2: flash attention.  bf16 != 0 means q, k, v and out are bf16, else
// f32.  kind: 0 causal, 1 local, 2 full.  splits: KV splits (bf16 at D = 64,
// 128 or 256 only; ws_o and ws_ml sized as in Args when splits > 1, else
// null).  Returns a cudaError_t value, checked after every launch.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const int32_t* qpos, const int32_t* kpos, void* out,
                        float* ws_o, float* ws_ml, int B, int S, int T,
                        int Hkv, int G, int D, int bf16, int kind, int window,
                        int splits, float softcap, float scale, int device,
                        void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || G <= 0) return 0;
  if (kind < kCausal || kind > kFullMask || splits < 1 ||
      (splits > 1 && (ws_o == nullptr || ws_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args a{q, k, v, qpos, kpos, out, ws_o, ws_ml, B, S, T, Hkv, G, kind,
         window, splits, softcap, scale};
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {  // the tensor-core instance where it has one, no fallback
    switch (D) {
      case 64: return launch_mma<64>(a, s);
      case 128: return launch_mma<128>(a, s);
      case 256: return launch_mma<256>(a, s);
    }
    return dispatch<__nv_bfloat16>(a, D, s);
  }
  return dispatch<float>(a, D, s);
}

// B2's latent (MLA) decode instance: q (B, S, H, dqk) bf16, one latent KV
// head ckv (B, T, dqk) bf16 whose first dv values are the value, qpos (B,
// S) int32; key t admitted where t <= qpos and t < T; out (B, S, H, dv)
// f32.  Only dqk = 576, dv = 512 (kv_lora_rank 512 + qk_rope_head_dim
// 64).  splits as flash_attention_fwd (ws_o (splits, B, S*H, dv), ws_ml
// (splits, B, S*H, 2)).  Returns a cudaError_t value.
int flash_attention_mla_fwd(const void* q, const void* ckv,
                            const int32_t* qpos, float* out, float* ws_o,
                            float* ws_ml, int B, int S, int T, int H, int dqk,
                            int dv, int splits, float scale, int device,
                            void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (dqk != 576 || dv != 512 || splits < 1 ||
      (splits > 1 && (ws_o == nullptr || ws_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args a{q, ckv, nullptr, qpos, nullptr, out, ws_o, ws_ml, B, S, T, 1, H,
         kCausal, 0, splits, 0.f, scale};
  return launch_mla<576, 512>(a, (cudaStream_t)stream);
}

}  // extern "C"
