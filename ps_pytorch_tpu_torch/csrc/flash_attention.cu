// Flash attention for Hopper (sm_90a): forward, dq and dk/dv kernels.
//
// Replaces the three Pallas kernels of ps_pytorch_tpu/ops/flash_attention.py:
//   _fwd_kernel  (forward: o and the per-row log-sum-exp),
//   _dq_kernel   (dq, accumulated over kv tiles),
//   _dkv_kernel  (dk and dv, accumulated over q tiles).
// Over q, k, v of shape [BH, S, D] (row-major, contiguous), for one head:
//   s    = (q * scale) k^T, masked to -1e30 where causal and key > query
//   o    = softmax(s) v             lse = m + log(max(l, 1e-30))
//   p    = exp(s - lse)             dp  = dO v^T          ds = p (dp - delta)
//   dq   = ds k * scale             dv  = p^T dO          dk = ds^T (q * scale)
// with delta = rowsum(dO * o) computed outside (ops/flash_attention.py), as
// the JAX package does outside Pallas. Inputs are float or bfloat16; bf16 is
// read as bf16 and turned into f32 in shared memory, and all arithmetic is
// f32. The forward rounds p to the value type before p v, as the Pallas
// kernel does (p.astype(v.dtype)); the backward keeps p in f32, as there.
// Outputs are in the input type; lse is f32.
//
// What bounds it on this card. Each (query, key) pair costs 2 D FMAs in the
// forward (q k^T and p v), 3 D in dq and 4 D in dk/dv. At the LM's full width
// (BH 64, S 2048, D 64, causal: 2,098,176 pairs a head) that is 34.4, 51.5
// and 68.7 GFLOP, 0.51, 0.77 and 1.03 ms at the 67 TFLOP/s f32 peak, while the
// bytes (q, k, v, dO, o once each, 34 MB a tensor) take about 0.04 ms at
// 3.35 TB/s: every kernel is bound by operations.
//
// Design. The Pallas kernels walk a sequential grid and carry the softmax
// statistics and accumulators in VMEM scratch from one grid step to the
// next. Here blocks run in any order, so each block owns one output tile and
// loops over the other axis itself: the forward and dq blocks own 64 query
// rows and loop over 64-key tiles; the dk/dv block owns 64 keys and loops
// over 64-query tiles, so no two blocks write the same output (no atomics,
// deterministic results). A block has 256 threads as a 16 x 16 grid; each
// thread holds a 4 x 4 piece of every 64 x 64 score tile (rows ty*4+i,
// columns tx+16j), so the 16 threads of one row are one half-warp and row
// max and sum are 4 shuffles. Tiles are staged in shared memory as f32 with
// rows padded to an odd stride (no bank conflicts when 16 threads read 16
// rows). The 64 x 64 probability (or ds) tile goes through shared memory
// for the second product. Causal tiles entirely above the diagonal are
// never loaded; the ragged last tile of a sequence whose length is not a
// multiple of 64 is zero-filled and masked. Everything runs as f32 FMA on
// the CUDA cores: right and simple first; mma/wgmma tiles on the tensor
// cores with TMA-fed shared memory are later work (ROADMAP.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BT = 64;          // rows of every tile: queries and keys alike
constexpr int TPB = 256;        // threads per block, a 16 x 16 grid
constexpr int PLD = BT + 1;     // padded row stride of a 64 x 64 smem tile
constexpr float NEG = -1e30f;   // the Pallas kernels' finite mask value

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA's convert
}

// The 16 threads of one tile row are one half-warp: xor offsets below 16
// stay inside it.
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Rows [row0, row0 + 64) of one [S, D] slab into smem tile dst[64][LD] as
// f32 times mul (q * scale, as the Pallas kernels scale q in f32). Rows at
// or past S and columns at or past D are zero.
template <typename T, int W>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int row0, int S, int D, float mul) {
  constexpr int LD = W + 1;
  for (int idx = threadIdx.x; idx < BT * W; idx += TPB) {
    const int r = idx / W, c = idx % W;
    const int g = row0 + r;
    dst[r * LD + c] =
        (g < S && c < D) ? to_f32<T>(src[(size_t)g * D + c]) * mul : 0.f;
  }
}

// acc[i][j] += sum_d a[ty*4+i][d] * b[tx+16j][d] over two smem tiles of
// stride LD: one 64 x 64 product tile, 4 x 4 of it in this thread.
template <int LD>
__device__ __forceinline__ void tile_abt(float acc[4][4], const float* a,
                                         const float* b, int D, int tx, int ty) {
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty * 4 + i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// out[i][jd] += sum_c p[ty*4+i][c] * m[c][tx+16jd]: the thread's 4 rows x
// DJ columns of (64 x 64 tile p) times (64 x W tile m of stride LD).
template <int DJ, int LD>
__device__ __forceinline__ void tile_pm(float out[4][DJ], const float* p,
                                        const float* m, int tx, int ty) {
#pragma unroll 4
  for (int c = 0; c < BT; ++c) {
    float pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = p[(ty * 4 + i) * PLD + c];
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd) {
      const float mv = m[c * LD + tx + 16 * jd];
#pragma unroll
      for (int i = 0; i < 4; ++i) out[i][jd] = fmaf(pv[i], mv, out[i][jd]);
    }
  }
}

// ---------------------------------------------------------------- forward
// grid (q tiles, BH); smem: q, k, v tiles [64][W+1] and p [64][65].
template <typename T, int DJ>
__global__ void __launch_bounds__(TPB)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int S, int D, int causal, float scale) {
  constexpr int W = 16 * DJ, LD = W + 1;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + BT * LD;
  float* vs = ks + BT * LD;
  float* ps = vs + BT * LD;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  // Causal: the last query tiles do the most work, so they start first.
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BT;
  const size_t base = (size_t)blockIdx.y * S * D;

  load_tile<T, W>(qs, q + base, q0, S, D, scale);
  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd) acc[i][jd] = 0.f;
  }
  const int q_end = min(q0 + BT, S);
  const int kv_end = causal ? q_end : S;   // keys past the last query: dead
  for (int k0 = 0; k0 < kv_end; k0 += BT) {
    __syncthreads();   // the previous tile's k, v and p are read
    load_tile<T, W>(ks, k + base, k0, S, D, 1.f);
    load_tile<T, W>(vs, v + base, k0, S, D, 1.f);
    __syncthreads();
    float s[4][4] = {};
    tile_abt<LD>(s, qs, ks, D, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        if (kp >= S || (causal && kp > qp)) s[i][j] = NEG;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        // p v takes p in the value type (the Pallas kernel's astype).
        ps[(ty * 4 + i) * PLD + tx + 16 * j] = to_f32<T>(from_f32<T>(p));
      }
      l[i] = alpha * l[i] + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int jd = 0; jd < DJ; ++jd) acc[i][jd] *= alpha;
    }
    __syncthreads();
    tile_pm<DJ, LD>(acc, ps, vs, tx, ty);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= S) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd) {
      const int d = tx + 16 * jd;
      if (d < D) o[base + (size_t)r * D + d] = from_f32<T>(acc[i][jd] / lc);
    }
    if (tx == 0) lse[(size_t)blockIdx.y * S + r] = m[i] + logf(lc);
  }
}

// --------------------------------------------------------------------- dq
// grid (q tiles, BH); smem: q, dO, k, v tiles [64][W+1] and ds [64][65].
template <typename T, int DJ>
__global__ void __launch_bounds__(TPB)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dq, int S, int D, int causal, float scale) {
  constexpr int W = 16 * DJ, LD = W + 1;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + BT * LD;
  float* ks = dos + BT * LD;
  float* vs = ks + BT * LD;
  float* dss = vs + BT * LD;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BT;
  const size_t base = (size_t)blockIdx.y * S * D;
  const size_t rbase = (size_t)blockIdx.y * S;

  load_tile<T, W>(qs, q + base, q0, S, D, scale);
  load_tile<T, W>(dos, dout + base, q0, S, D, 1.f);
  float lse_r[4], delta_r[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    lse_r[i] = r < S ? lse[rbase + r] : 0.f;
    delta_r[i] = r < S ? delta[rbase + r] : 0.f;
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd) acc[i][jd] = 0.f;
  }
  const int q_end = min(q0 + BT, S);
  const int kv_end = causal ? q_end : S;
  for (int k0 = 0; k0 < kv_end; k0 += BT) {
    __syncthreads();
    load_tile<T, W>(ks, k + base, k0, S, D, 1.f);
    load_tile<T, W>(vs, v + base, k0, S, D, 1.f);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    tile_abt<LD>(s, qs, ks, D, tx, ty);
    tile_abt<LD>(dp, dos, vs, D, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool dead = kp >= S || qp >= S || (causal && kp > qp);
        const float p = dead ? 0.f : expf(s[i][j] - lse_r[i]);
        dss[(ty * 4 + i) * PLD + tx + 16 * j] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();
    tile_pm<DJ, LD>(acc, dss, ks, tx, ty);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= S) continue;
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd) {
      const int d = tx + 16 * jd;
      if (d < D) dq[base + (size_t)r * D + d] = from_f32<T>(acc[i][jd] * scale);
    }
  }
}

// ------------------------------------------------------------------ dk/dv
// grid (kv tiles, BH); smem: k, v, q, dO tiles [64][W+1], p^T and ds^T
// [64][65], and the q tile's lse and delta. Thread rows are keys here.
template <typename T, int DJ>
__global__ void __launch_bounds__(TPB)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 T* __restrict__ dk, T* __restrict__ dv, int S, int D,
                 int causal, float scale) {
  constexpr int W = 16 * DJ, LD = W + 1;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + BT * LD;
  float* qs = vs + BT * LD;
  float* dos = qs + BT * LD;
  float* pt = dos + BT * LD;
  float* dst = pt + BT * PLD;
  float* lse_s = dst + BT * PLD;
  float* delta_s = lse_s + BT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  // Causal: the first key tiles are seen by the most queries; they start
  // first.
  const int k0 = blockIdx.x * BT;
  const size_t base = (size_t)blockIdx.y * S * D;
  const size_t rbase = (size_t)blockIdx.y * S;

  load_tile<T, W>(ks, k + base, k0, S, D, 1.f);
  load_tile<T, W>(vs, v + base, k0, S, D, 1.f);
  float dk_acc[4][DJ], dv_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd) dk_acc[i][jd] = dv_acc[i][jd] = 0.f;
  // Causal: queries before this tile's first key see none of it.
  const int q_start = causal ? k0 : 0;
  for (int q0 = q_start; q0 < S; q0 += BT) {
    __syncthreads();
    load_tile<T, W>(qs, q + base, q0, S, D, scale);
    load_tile<T, W>(dos, dout + base, q0, S, D, 1.f);
    if (threadIdx.x < BT) {
      const int r = q0 + threadIdx.x;
      lse_s[threadIdx.x] = r < S ? lse[rbase + r] : 0.f;
      delta_s[threadIdx.x] = r < S ? delta[rbase + r] : 0.f;
    }
    __syncthreads();
    float st[4][4] = {}, dpt[4][4] = {};
    tile_abt<LD>(st, ks, qs, D, tx, ty);    // s^T: keys x queries
    tile_abt<LD>(dpt, vs, dos, D, tx, ty);  // dp^T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kp = k0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int qp = q0 + c;
        const bool dead = qp >= S || kp >= S || (causal && kp > qp);
        const float p = dead ? 0.f : expf(st[i][j] - lse_s[c]);
        pt[(ty * 4 + i) * PLD + c] = p;
        dst[(ty * 4 + i) * PLD + c] = p * (dpt[i][j] - delta_s[c]);
      }
    }
    __syncthreads();
    tile_pm<DJ, LD>(dv_acc, pt, dos, tx, ty);   // dv += p^T dO
    tile_pm<DJ, LD>(dk_acc, dst, qs, tx, ty);   // dk += ds^T (q * scale)
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty * 4 + i;
    if (r >= S) continue;
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd) {
      const int d = tx + 16 * jd;
      if (d < D) {
        dk[base + (size_t)r * D + d] = from_f32<T>(dk_acc[i][jd]);
        dv[base + (size_t)r * D + d] = from_f32<T>(dv_acc[i][jd]);
      }
    }
  }
}

// ----------------------------------------------------------------- launch
constexpr size_t tile_bytes(int dj) { return sizeof(float) * BT * (16 * dj + 1); }
constexpr size_t fwd_smem(int dj) { return 3 * tile_bytes(dj) + sizeof(float) * BT * PLD; }
constexpr size_t dq_smem(int dj) { return 4 * tile_bytes(dj) + sizeof(float) * BT * PLD; }
constexpr size_t dkv_smem(int dj) {
  return 4 * tile_bytes(dj) + 2 * sizeof(float) * BT * PLD + 2 * sizeof(float) * BT;
}

int check_shape(int BH, int S, int D) {
  if (BH <= 0 || BH > 65535 || S <= 0 || D <= 0 || D > 128 || D % 8 != 0)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// Sets the kernel's dynamic shared memory (above 48 KB needs the opt-in)
// and launches it on the caller's stream; returns the CUDA error, 0 if the
// launch was accepted.
template <typename K, typename... Args>
int launch(K kernel, int S, int BH, size_t smem, void* stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((S + BT - 1) / BT), (unsigned)BH);
  kernel<<<grid, TPB, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return (int)cudaGetLastError();
}

template <typename T, int DJ>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int BH, int S, int D, int causal, float scale, void* stream) {
  return launch(flash_fwd_kernel<T, DJ>, S, BH, fwd_smem(DJ), stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<T*>(o),
                static_cast<float*>(lse), S, D, causal, scale);
}

template <typename T, int DJ>
int dq(const void* q, const void* k, const void* v, const void* dout,
       const void* lse, const void* delta, void* dq_out, int BH, int S, int D,
       int causal, float scale, void* stream) {
  return launch(flash_dq_kernel<T, DJ>, S, BH, dq_smem(DJ), stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const T*>(dout),
                static_cast<const float*>(lse), static_cast<const float*>(delta),
                static_cast<T*>(dq_out), S, D, causal, scale);
}

template <typename T, int DJ>
int dkv(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dk, void* dv, int BH, int S,
        int D, int causal, float scale, void* stream) {
  return launch(flash_dkv_kernel<T, DJ>, S, BH, dkv_smem(DJ), stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const T*>(dout),
                static_cast<const float*>(lse), static_cast<const float*>(delta),
                static_cast<T*>(dk), static_cast<T*>(dv), S, D, causal, scale);
}

// Head dims up to 16, 32, 64 and 128 columns: 1, 2, 4 or 8 per thread.
template <typename T>
int fwd_any(const void* q, const void* k, const void* v, void* o, void* lse,
            int BH, int S, int D, int causal, float scale, void* stream) {
  if (int e = check_shape(BH, S, D)) return e;
  if (D <= 16) return fwd<T, 1>(q, k, v, o, lse, BH, S, D, causal, scale, stream);
  if (D <= 32) return fwd<T, 2>(q, k, v, o, lse, BH, S, D, causal, scale, stream);
  if (D <= 64) return fwd<T, 4>(q, k, v, o, lse, BH, S, D, causal, scale, stream);
  return fwd<T, 8>(q, k, v, o, lse, BH, S, D, causal, scale, stream);
}

template <typename T>
int dq_any(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq_out, int BH, int S,
           int D, int causal, float scale, void* stream) {
  if (int e = check_shape(BH, S, D)) return e;
  if (D <= 16)
    return dq<T, 1>(q, k, v, dout, lse, delta, dq_out, BH, S, D, causal, scale, stream);
  if (D <= 32)
    return dq<T, 2>(q, k, v, dout, lse, delta, dq_out, BH, S, D, causal, scale, stream);
  if (D <= 64)
    return dq<T, 4>(q, k, v, dout, lse, delta, dq_out, BH, S, D, causal, scale, stream);
  return dq<T, 8>(q, k, v, dout, lse, delta, dq_out, BH, S, D, causal, scale, stream);
}

template <typename T>
int dkv_any(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv, int BH,
            int S, int D, int causal, float scale, void* stream) {
  if (int e = check_shape(BH, S, D)) return e;
  if (D <= 16)
    return dkv<T, 1>(q, k, v, dout, lse, delta, dk, dv, BH, S, D, causal, scale, stream);
  if (D <= 32)
    return dkv<T, 2>(q, k, v, dout, lse, delta, dk, dv, BH, S, D, causal, scale, stream);
  if (D <= 64)
    return dkv<T, 4>(q, k, v, dout, lse, delta, dk, dv, BH, S, D, causal, scale, stream);
  return dkv<T, 8>(q, k, v, dout, lse, delta, dk, dv, BH, S, D, causal, scale, stream);
}

}  // namespace

// The entry points: plain C, one per kernel and input type. Pointers are
// device pointers of contiguous [BH, S, D] tensors ([BH, S] f32 for lse and
// delta). Each returns the CUDA error of its launch, 0 when it was accepted.

extern "C" int psk_flash_fwd_f32(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int BH, int S, int D,
                                 int causal, float scale, void* stream) {
  return fwd_any<float>(q, k, v, o, lse, BH, S, D, causal, scale, stream);
}

extern "C" int psk_flash_fwd_bf16(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int BH, int S, int D,
                                  int causal, float scale, void* stream) {
  return fwd_any<__nv_bfloat16>(q, k, v, o, lse, BH, S, D, causal, scale, stream);
}

extern "C" int psk_flash_dq_f32(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq_out, int BH, int S,
                                int D, int causal, float scale, void* stream) {
  return dq_any<float>(q, k, v, dout, lse, delta, dq_out, BH, S, D, causal,
                       scale, stream);
}

extern "C" int psk_flash_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq_out, int BH, int S,
                                 int D, int causal, float scale, void* stream) {
  return dq_any<__nv_bfloat16>(q, k, v, dout, lse, delta, dq_out, BH, S, D,
                               causal, scale, stream);
}

extern "C" int psk_flash_dkv_f32(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv, int BH,
                                 int S, int D, int causal, float scale,
                                 void* stream) {
  return dkv_any<float>(q, k, v, dout, lse, delta, dk, dv, BH, S, D, causal,
                        scale, stream);
}

extern "C" int psk_flash_dkv_bf16(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv, int BH,
                                  int S, int D, int causal, float scale,
                                  void* stream) {
  return dkv_any<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, BH, S, D,
                                causal, scale, stream);
}
