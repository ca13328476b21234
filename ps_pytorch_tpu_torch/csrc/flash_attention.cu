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
// the JAX package does outside Pallas. Inputs are float, bfloat16 or half,
// all sums are f32, outputs are in the input type and lse is f32. The
// forward rounds p to the value type before p v, as the Pallas kernel does
// (p.astype(v.dtype)).
//
// What bounds them on this card. Each (query, key) pair costs 2 D
// multiply-adds in the forward (q k^T and p v), 3 D in dq and 4 D in dk/dv.
// At the LM's full width (BH 64, S 2048, D 64, causal: 2,098,176 pairs a
// head) that is 34.4, 51.5 and 68.7 GFLOP: 0.51, 0.77 and 1.03 ms at the
// 67 TFLOP/s f32 peak of the CUDA cores; 0.21, 0.31 and 0.42 ms as 3xTF32
// on the tensor cores (three 495 TFLOP/s TF32 products for one f32
// product); 0.035, 0.052 and 0.070 ms in bf16 or f16 at 989 TFLOP/s. The
// bytes
// (q, k, v, dO, o once each, 34 MB a tensor in f32) take about 0.04 ms at
// 3.35 TB/s: every kernel is bound by operations.
//
// All three kernels: blocks run in any order, so each block owns one output
// tile of 64 rows and loops over the other axis itself (the Pallas kernels
// carry their sums in VMEM from one sequential grid step to the next). The
// forward and dq blocks own 64 query rows and loop over key tiles; the
// dk/dv block owns 64 keys and loops over query tiles. No two blocks write
// the same output: no atomics, and the results do not change from run to
// run. Causal tiles entirely above the diagonal are never loaded; the
// ragged last tile of a sequence whose length is not a multiple of the tile
// is zero-filled and masked.
//
// All three run on the tensor cores, with warp-level mma.sync. Four warps
// a block, each owning 16 rows of the block's tile, so a warp's products
// are m16 tiles: s = q k^T (keys as N) and then p v in the forward; s =
// q k^T and dp = dO v^T in dq, then ds k; in dk/dv the block computes s^T =
// k q^T and dp^T = v dO^T with its keys as M, so p^T and ds^T come out as
// the rows of the block's own outputs, then p^T dO and ds^T q for dv and
// dk. The block's own tiles (q in the forward; q and dO in dq; k and v in
// dk/dv) are loaded once; the other axis's tiles (and in dk/dv their lse
// and delta) are staged in shared memory by 16-byte cp.async,
// double-buffered in bf16 and f16 so the next tile loads during this tile's
// products; f32 loads one tile at a time and spends the shared memory saved
// on more blocks an SM, which its long chains of dependent products need
// more (the launch section). Shared-memory rows are padded by 16 bytes,
// which makes every ldmatrix and every scalar fragment read below free of
// bank conflicts. q is not scaled in shared memory: the scores are scaled
// after the product and dq, dk by scale at the end.
//   The forward keeps its softmax in registers. The m16n8 accumulator lane
//   4g + t holds rows g and g + 8 of its warp's 16, columns 2t and 2t + 1
//   of each 8-key tile: a row's max and sum over a 64-key tile are the
//   lane's own 16 columns and then two shuffles across its quad (xor 1,
//   2). The running max m (in log2 units: the scores times scale log2(e),
//   so every exponential is one exp2) stays per row in registers; the
//   running sum l per lane, rescaled with the accumulator by alpha =
//   2^(m_old - m_new) before p v is added, and summed over the quad once at
//   the end, where o = acc / max(l, 1e-30) and lse = m ln 2 + log(max(l,
//   1e-30)) are written (lse in f32). l sums the unrounded p, as the
//   reference does; p v takes p in the value type (the reference's
//   p.astype(v.dtype): a no-op in f32, round to nearest even in bf16).
//   Masked scores are the reference's finite -1e30, so a row never meets
//   inf - inf.
//
//   f32 as 3xTF32 (m16n8k8). One TF32 product keeps 10 mantissa bits and
//   misses the reference's 5e-4 on the gradients by 4x and its 2e-5 on o
//   and lse by 11-48x (an error in s is multiplied by exp); emulated, the
//   3xTF32 forward errs about 1e-6 (tests/test_torch_flash.py). Each operand x is split into hi, x truncated to TF32
//   (a mask), and lo = x - hi (exact in f32), and every product is
//   a_lo b_hi + a_hi b_lo + a_hi b_hi into the f32 accumulator, the small
//   terms first. The tensor cores read only the top 19 bits of a 32-bit
//   operand, so hi is formed explicitly and lo taken against that same hi,
//   never against a value the hardware would read otherwise; lo is passed
//   as it is and truncated as it is read, leaving at most 2^-20 of x out of
//   a product. Emulated against f64 on the CPU (tests/test_torch_flash.py)
//   the gradients err 2-4x as much as f32 FMA sums and several hundred
//   times less than one TF32 product. Two instructions an element, no cvt:
//   cvt.rna.tf32 runs on the quarter-rate conversion pipe, and with two of
//   them an element the splits took more issue time than the products (an
//   integer round of hi, in place of the truncation, was slower too).
//   Fragments are read from the plain f32 tiles and split in registers:
//   ldmatrix (16-byte rows of 4 floats give the (row, k) fragments of
//   m16n8k8 directly) where k runs along a tile's row, scalar loads where k
//   runs down it. wgmma is not used for f32: its TF32 form
//   takes only K-major operands in shared memory, three of the five
//   products read their B tile down its rows, and hi and lo copies of every
//   B tile would need about 256 KB a block at D = 64, above the 227 KB a
//   block may use.
//   p and ds stay in registers between products. The accumulator holds
//   columns 2t and 2t+1 of each 8-column tile where an m16n8k8 A fragment
//   wants t and t+4; the k order of a product is free, so the second
//   product takes key 2t as its k = t and key 2t+1 as k = t+4, and reads its
//   B rows in the same order: the accumulator is the A fragment as it is.
//   bf16 on the same tiles (m16n8k16, one product each). The accumulators
//   of two 8-column tiles are an A fragment after packing to bf16 pairs;
//   B tiles read down their rows come from ldmatrix.trans. p and ds are
//   rounded to bf16 for their products, as the tensor cores take bf16
//   operands (the plain version keeps them f32: within the bf16 2e-2).
//   f16 is the bf16 route's twin: the same tiles, cp.async staging and
//   ldmatrix reads (both are 16-bit), mma m16n8k16 .f16.f16 with f32 sums,
//   p and ds packed to f16 pairs (round to nearest even: 3 more mantissa
//   bits than bf16, so within the f16 1e-2), outputs rounded once to f16.
//   f16's range ends at 65504: p <= 1, and an output past it is inf, as
//   XLA's convert gives.
// D is padded to a multiple of 16 in shared memory (zero-filled); the
// products run to D rounded up to the k step (8 f32, 16 bf16) and skip the
// rest. Tiles: the forward and dq own 64 queries and loop over 64 keys;
// dk/dv owns 64 keys and loops over 64 queries in bf16 and f16 and 32 in
// f32 (and
// in both at D > 64, where dk and dv take 64 f32 registers each). The
// forward reads q's fragments from its shared-memory tile at every key
// tile, as dq does, rather than holding them split in registers beside its
// accumulator (64 f32 registers at D = 128). At D = 64: f32 dq 148
// registers and 70 KB of shared memory a block (three blocks an SM), f32
// dk/dv 127 and 52 KB (four); bf16 dq 128 and 55 KB, bf16 dk/dv 168 and 55
// KB; no spills at any D (214-242 registers at D = 128). The forward: f32
// 117 registers and 52 KB a block at D = 64 (four blocks an SM), bf16 102
// and 46 KB; at D = 128 f32 146 and bf16 128, which spills 24 bytes (D =
// 128 bf16 is on no main path; __launch_bounds__ with one block an SM
// removes the spill but lifts the registers of every instantiation).
// Launch order puts the blocks with the most tiles first (grid x = BH,
// y = tile).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int BT = 64;          // rows of every tile: queries and keys alike
constexpr float NEG = -1e30f;   // the Pallas kernels' finite mask value

// -------------------------------------------------- tensor-core helpers
constexpr int TC_THREADS = 128;   // 4 warps, 16 rows of the block's tile each
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !valid (src-size 0:
// nothing is read; src stays a valid address all the same).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8 x 8 matrices of 16-bit elements (8 rows of 16 bytes each); lane l
// names row l % 8 of matrix l / 8 and receives, of each matrix, the 32 bits
// at row l / 4, bytes 4 (l % 4) .. +3 (.trans: the transposed matrix).
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragment layouts (lane = 4 g + t). An accumulator c[4] of an m16n8 tile
// holds (row g, cols 2t, 2t+1) and (row g+8, cols 2t, 2t+1).
//   m16n8k8 tf32:  A (g, t) (g+8, t) (g, t+4) (g+8, t+4); B (k t, n g)
//                  (k t+4, n g).
//   m16n8k16 bf16 and f16: A pairs (g, 2t..) (g+8, 2t..) (g, 2t+8..)
//                  (g+8, 2t+8..); B pairs (k 2t.., n g) (k 2t+8.., n g).
template <typename T> struct Mma;

template <> struct Mma<float> {
  static constexpr int KS = 8;   // k of one product
  struct A { uint32_t hi[4], lo[4]; };
  struct B { uint32_t hi[2], lo[2]; };
  // hi: x truncated to TF32, which is what the tensor cores would read of
  // x; lo = x - hi, exact in f32, which they truncate as they read it. Two
  // instructions an element (header).
  static __device__ __forceinline__ void split(float x, uint32_t& hi,
                                               uint32_t& lo) {
    hi = __float_as_uint(x) & 0xFFFFE000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
  }
  static __device__ __forceinline__ A a(const uint32_t r[4]) {
    A f;
#pragma unroll
    for (int i = 0; i < 4; ++i) split(__uint_as_float(r[i]), f.hi[i], f.lo[i]);
    return f;
  }
  static __device__ __forceinline__ B b(uint32_t r0, uint32_t r1) {
    B f;
    split(__uint_as_float(r0), f.hi[0], f.lo[0]);
    split(__uint_as_float(r1), f.hi[1], f.lo[1]);
    return f;
  }
  // k step kk of a product whose A is the accumulators acc[8 NK][4]: key 2t
  // is k = t and key 2t+1 is k = t+4 (see the header).
  static __device__ __forceinline__ A a_acc(const float (*acc)[4], int kk) {
    A f;
    split(acc[kk][0], f.hi[0], f.lo[0]);
    split(acc[kk][2], f.hi[1], f.lo[1]);
    split(acc[kk][1], f.hi[2], f.lo[2]);
    split(acc[kk][3], f.hi[3], f.lo[3]);
    return f;
  }
  static __device__ __forceinline__ void mma1(float c[4], const uint32_t a[4],
                                              const uint32_t b[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  static __device__ __forceinline__ void run(float c[4], const A& a,
                                             const B& b) {
    mma1(c, a.lo, b.hi);
    mma1(c, a.hi, b.lo);
    mma1(c, a.hi, b.hi);
  }
};

// The 16-bit types: one m16n8k16 product on the same fragments. The
// accumulators of column tiles 2 kk and 2 kk + 1 pack to the A fragment of
// k step kk; the instruction names the type.
template <typename H> struct Mma16 {
  static constexpr int KS = 16;
  static constexpr bool F16 = std::is_same<H, __half>::value;
  struct A { uint32_t v[4]; };
  struct B { uint32_t v[2]; };
  static __device__ __forceinline__ A a(const uint32_t r[4]) {
    return A{{r[0], r[1], r[2], r[3]}};
  }
  static __device__ __forceinline__ B b(uint32_t r0, uint32_t r1) {
    return B{{r0, r1}};
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    if constexpr (F16) return pack_f16(lo, hi);
    else return pack_bf16(lo, hi);
  }
  static __device__ __forceinline__ A a_acc(const float (*acc)[4], int kk) {
    const float* c = acc[2 * kk];
    const float* d = acc[2 * kk + 1];
    return A{{pack(c[0], c[1]), pack(c[2], c[3]), pack(d[0], d[1]),
              pack(d[2], d[3])}};
  }
  static __device__ __forceinline__ void run(float c[4], const A& a,
                                             const B& b) {
    if constexpr (F16)
      asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
          : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(b.v[0]),
            "r"(b.v[1]));
    else
      asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
          : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(b.v[0]),
            "r"(b.v[1]));
  }
};
template <> struct Mma<__nv_bfloat16> : Mma16<__nv_bfloat16> {};
template <> struct Mma<__half> : Mma16<__half> {};

// A shared-memory tile: ROWS rows of DP elements (D zero-padded to DP),
// each row RB = DP * sizeof(T) + 16 bytes.
template <typename T, int DP>
struct Tile {
  static constexpr int RB = DP * (int)sizeof(T) + 16;
  static constexpr int CHUNKS = DP * (int)sizeof(T) / 16;   // a row's 16 B
};

// Rows [row0, row0 + ROWS) of one [S, D] slab into a tile by cp.async;
// rows at or past S and 16-byte chunks at or past D are zero-filled.
template <typename T, int DP, int ROWS>
__device__ __forceinline__ void load_tile_async(uint32_t dst,
                                                const T* __restrict__ slab,
                                                int row0, int S, int D) {
  using Tl = Tile<T, DP>;
  const int data_chunks = D * (int)sizeof(T) / 16;   // D % 8 == 0
  const char* src0 = reinterpret_cast<const char*>(slab);
  for (int idx = threadIdx.x; idx < ROWS * Tl::CHUNKS; idx += TC_THREADS) {
    const int r = idx / Tl::CHUNKS, c = idx % Tl::CHUNKS;
    const int g = row0 + r;
    const bool ok = g < S && c < data_chunks;
    const char* src =
        ok ? src0 + ((size_t)g * D * sizeof(T) + (size_t)c * 16) : src0;
    cp_async16(dst + r * Tl::RB + c * 16, src, ok);
  }
}

// ROWS f32 values [row0, row0 + ROWS) of one [S] row vector (lse, delta),
// zero past S.
template <int ROWS>
__device__ __forceinline__ void load_rows_async(uint32_t dst,
                                                const float* __restrict__ v,
                                                int row0, int S) {
  if (threadIdx.x < ROWS) {
    const int g = row0 + threadIdx.x;
    cp_async4(dst + 4 * threadIdx.x, g < S ? v + g : v, g < S);
  }
}

// acc[j] (8 NT columns) += A[16 rows at a][0, kdepth) * B[8 NT rows at
// b][0, kdepth)^T: both tiles hold k along their rows, read by ldmatrix.
template <typename T, int DP, int NT>
__device__ __forceinline__ void mma_abt(float (*acc)[4], uint32_t a,
                                        uint32_t b, int kdepth, int lane) {
  using M = Mma<T>;
  constexpr int RB = Tile<T, DP>::RB;
  const int lr = lane & 7, lm = lane >> 3;
  // A: matrices (rows 0-7, chunk 0), (8-15, 0), (0-7, 1), (8-15, 1).
  const uint32_t a_addr = a + (lr + 8 * (lm & 1)) * RB + 16 * (lm >> 1);
  // B: (rows 0-7, chunk 0), (0-7, 1), (8-15, 0), (8-15, 1): two n tiles.
  const uint32_t b_addr = b + (lr + 8 * (lm >> 1)) * RB + 16 * (lm & 1);
#pragma unroll
  for (int kk = 0; kk < DP / M::KS; ++kk) {
    if (kk * M::KS < kdepth) {
      uint32_t r[4];
      ldsm_x4(r, a_addr + 32 * kk);
      const typename M::A fa = M::a(r);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        ldsm_x4(r, b_addr + 8 * j * RB + 32 * kk);
        M::run(acc[j], fa, M::b(r[0], r[1]));
        M::run(acc[j + 1], fa, M::b(r[2], r[3]));
      }
    }
  }
}

// out[jd] (8 ND columns, those below D) += P[16 rows][8 NK] * X[8 NK
// rows][0, 8 ND): P is this warp's accumulators p[NK][4], X a tile at x
// holding the k index down its rows.
template <typename T, int DP, int ND, int NK>
__device__ __forceinline__ void mma_pb(float (*out)[4], const float (*p)[4],
                                       const unsigned char* x_gen,
                                       uint32_t x, int D, int lane) {
  using M = Mma<T>;
  constexpr int RB = Tile<T, DP>::RB;
  const int g = lane >> 2, t = lane & 3;
  if constexpr (M::KS == 8) {
    // f32: B (k t, n g) is key 8 kk + 2t, (k t+4, n g) key 8 kk + 2t + 1.
    const float* xf = reinterpret_cast<const float*>(x_gen);
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const typename M::A fa = M::a_acc(p, kk);
      const float* row = xf + (8 * kk + 2 * t) * (RB / 4) + g;
#pragma unroll
      for (int jd = 0; jd < ND; ++jd) {
        if (8 * jd < D) {
          const float b0 = row[8 * jd], b1 = row[RB / 4 + 8 * jd];
          M::run(out[jd], fa,
                 M::b(__float_as_uint(b0), __float_as_uint(b1)));
        }
      }
    }
  } else {
    // bf16, f16: ldmatrix.trans of (k rows 0-7, n 0-7), (8-15, 0-7), (0-7,
    // 8-15), (8-15, 8-15): two n tiles.
    const int lr = lane & 7, lm = lane >> 3;
    const uint32_t x_addr = x + (lr + 8 * (lm & 1)) * RB + 16 * (lm >> 1);
#pragma unroll
    for (int kk = 0; kk < NK / 2; ++kk) {
      const typename M::A fa = M::a_acc(p, kk);
#pragma unroll
      for (int jd = 0; jd < ND; jd += 2) {
        if (8 * jd < D) {
          uint32_t r[4];
          ldsm_x4_t(r, x_addr + 16 * kk * RB + 16 * jd);
          M::run(out[jd], fa, M::b(r[0], r[1]));
          M::run(out[jd + 1], fa, M::b(r[2], r[3]));
        }
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* dst, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* dst,
                                                      float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}
template <>
__device__ __forceinline__ void store2<__half>(__half* dst, float a, float b) {
  *reinterpret_cast<__half2*>(dst) = __floats2half2_rn(a, b);
}

// A warp's 16 output rows (r and r + 8 in this lane) of [S, D] times mul.
template <typename T, int ND>
__device__ __forceinline__ void store_rows(T* __restrict__ out,
                                           const float (*acc)[4], int r,
                                           int S, int D, float mul, int t) {
#pragma unroll
  for (int jd = 0; jd < ND; ++jd) {
    const int c = 8 * jd + 2 * t;
    if (c >= D) continue;
    if (r < S)
      store2<T>(out + (size_t)r * D + c, acc[jd][0] * mul, acc[jd][1] * mul);
    if (r + 8 < S)
      store2<T>(out + (size_t)(r + 8) * D + c, acc[jd][2] * mul,
                acc[jd][3] * mul);
  }
}

// ---------------------------------------------------------------- forward
// grid (BH, q tiles); smem: the q tile, then STAGES (1 or 2) stages of k
// and v tiles.
template <typename T, int DP, int STAGES>
__global__ void __launch_bounds__(TC_THREADS)
flash_fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o,
                    float* __restrict__ lse, int S, int D, int causal,
                    float scale) {
  constexpr int RB = Tile<T, DP>::RB, TILE = BT * RB;
  constexpr int NT = BT / 8, ND = DP / 8;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t s0 = smem_addr(tc_smem);
  const uint32_t kv0 = s0 + TILE;                      // k, v of stage 0
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane & 3;
  // Causal: the last query tiles see the most keys; they start first.
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BT;
  const size_t base = (size_t)blockIdx.x * S * D;
  const int kdepth = (D + Mma<T>::KS - 1) / Mma<T>::KS * Mma<T>::KS;
  const int n_kv = ((causal ? min(q0 + BT, S) : S) + BT - 1) / BT;

  load_tile_async<T, DP, BT>(s0, q + base, q0, S, D);
  load_tile_async<T, DP, BT>(kv0, k + base, 0, S, D);
  load_tile_async<T, DP, BT>(kv0 + TILE, v + base, 0, S, D);
  cp_async_commit();

  const int ra = q0 + 16 * warp + (lane >> 2);   // rows ra and ra + 8
  const float scale2 = scale * LOG2E;
  // Per row h (0: ra, 1: ra + 8): the running max of the scores in log2
  // units, and this lane's share of the running sum.
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float acc[ND][4] = {};

  for (int it = 0; it < n_kv; ++it) {
    const int st = STAGES == 2 ? it & 1 : 0;   // the stages as in dq
    if constexpr (STAGES == 2) {
      if (it + 1 < n_kv) {
        const uint32_t next = kv0 + 2 * (st ^ 1) * TILE;
        load_tile_async<T, DP, BT>(next, k + base, (it + 1) * BT, S, D);
        load_tile_async<T, DP, BT>(next + TILE, v + base, (it + 1) * BT, S,
                                   D);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      if (it > 0) {
        load_tile_async<T, DP, BT>(kv0, k + base, it * BT, S, D);
        load_tile_async<T, DP, BT>(kv0 + TILE, v + base, it * BT, S, D);
        cp_async_commit();
      }
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t ks = kv0 + 2 * st * TILE;
    float s[NT][4] = {};
    mma_abt<T, DP, NT>(s, s0 + 16 * warp * RB, ks, kdepth, lane);
    const int k0 = it * BT;
    // Only the diagonal tile (causal) and the ragged last tile hold masked
    // scores; the others skip the test.
    if (k0 + BT > S || (causal && k0 + BT - 1 > q0)) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = ra + 8 * (e >> 1);
          const int col = k0 + 8 * j + 2 * t + (e & 1);
          if (col >= S || (causal && col > row)) s[j][e] = NEG;
        }
      }
    }
    // The row max of the raw products, then in log2 units (scale2 > 0, so
    // the max commutes with the scaling, rounding included).
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h] * scale2);
      alpha[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(fmaf(s[j][e], scale2, -m[e >> 1]));   // p
        l[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int jd = 0; jd < ND; ++jd) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jd][e] *= alpha[e >> 1];
    }
    mma_pb<T, DP, ND, NT>(acc, s, tc_smem + (ks + TILE - s0), ks + TILE, D,
                          lane);
    __syncthreads();   // the stage is refilled from here on
  }
  float lc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    lc[h] = fmaxf(l[h], 1e-30f);
    const float inv = 1.f / lc[h];
#pragma unroll
    for (int jd = 0; jd < ND; ++jd) {
      acc[jd][2 * h] *= inv;
      acc[jd][2 * h + 1] *= inv;
    }
  }
  store_rows<T, ND>(o + base, acc, ra, S, D, 1.f, t);
  if (t == 0) {
    float* lse_bh = lse + (size_t)blockIdx.x * S;
    if (ra < S) lse_bh[ra] = m[0] * LN2 + logf(lc[0]);
    if (ra + 8 < S) lse_bh[ra + 8] = m[1] * LN2 + logf(lc[1]);
  }
}

// --------------------------------------------------------------------- dq
// grid (BH, q tiles); smem: q and dO tiles, then STAGES (1 or 2) stages of
// k and v tiles.
template <typename T, int DP, int STAGES>
__global__ void __launch_bounds__(TC_THREADS)
flash_dq_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq,
                   int S, int D, int causal, float scale) {
  using M = Mma<T>;
  constexpr int RB = Tile<T, DP>::RB, TILE = BT * RB;
  constexpr int NT = BT / 8, ND = DP / 8;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t s0 = smem_addr(tc_smem);
  const uint32_t kv0 = s0 + 2 * TILE;                  // k, v of stage 0
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  // Causal: the last query tiles see the most keys; they start first.
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BT;
  const size_t base = (size_t)blockIdx.x * S * D;
  const size_t rbase = (size_t)blockIdx.x * S;
  const int kdepth = (D + M::KS - 1) / M::KS * M::KS;
  const int n_kv = ((causal ? min(q0 + BT, S) : S) + BT - 1) / BT;

  load_tile_async<T, DP, BT>(s0, q + base, q0, S, D);
  load_tile_async<T, DP, BT>(s0 + TILE, dout + base, q0, S, D);
  load_tile_async<T, DP, BT>(kv0, k + base, 0, S, D);
  load_tile_async<T, DP, BT>(kv0 + TILE, v + base, 0, S, D);
  cp_async_commit();

  const int ra = q0 + 16 * warp + g, rb = ra + 8;   // this lane's rows
  const float lse_a = ra < S ? lse[rbase + ra] * LOG2E : 0.f;
  const float lse_b = rb < S ? lse[rbase + rb] * LOG2E : 0.f;
  const float delta_a = ra < S ? delta[rbase + ra] : 0.f;
  const float delta_b = rb < S ? delta[rbase + rb] : 0.f;
  const float scale2 = scale * LOG2E;
  float acc[ND][4] = {};

  for (int it = 0; it < n_kv; ++it) {
    // Two stages: the next tile loads during this one's products. One
    // stage: it loads here, and the shared memory saved lets more blocks
    // share the SM.
    const int st = STAGES == 2 ? it & 1 : 0;
    if constexpr (STAGES == 2) {
      if (it + 1 < n_kv) {
        const uint32_t next = kv0 + 2 * (st ^ 1) * TILE;
        load_tile_async<T, DP, BT>(next, k + base, (it + 1) * BT, S, D);
        load_tile_async<T, DP, BT>(next + TILE, v + base, (it + 1) * BT, S,
                                   D);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      if (it > 0) {
        load_tile_async<T, DP, BT>(kv0, k + base, it * BT, S, D);
        load_tile_async<T, DP, BT>(kv0 + TILE, v + base, it * BT, S, D);
        cp_async_commit();
      }
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t ks = kv0 + 2 * st * TILE;
    float s[NT][4] = {}, dp[NT][4] = {};
    mma_abt<T, DP, NT>(s, s0 + 16 * warp * RB, ks, kdepth, lane);
    mma_abt<T, DP, NT>(dp, s0 + TILE + 16 * warp * RB, ks + TILE, kdepth,
                       lane);
    const int k0 = it * BT;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? ra : rb;
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        const bool dead = col >= S || row >= S || (causal && col > row);
        const float p = dead ? 0.f
            : exp2f(fmaf(s[j][e], scale2, -(e < 2 ? lse_a : lse_b)));
        s[j][e] = p * (dp[j][e] - (e < 2 ? delta_a : delta_b));   // ds
      }
    }
    mma_pb<T, DP, ND, NT>(acc, s, tc_smem + (ks - s0), ks, D, lane);
    __syncthreads();   // the stage is refilled from here on
  }
  store_rows<T, ND>(dq + base, acc, ra, S, D, scale, t);
}

// ------------------------------------------------------------------ dk/dv
// grid (BH, kv tiles); smem: k and v tiles, then STAGES (1 or 2) stages
// of BQ query rows of q and dO, then as many of their lse and delta. The
// block's keys are the products' M rows.
template <typename T, int DP, int BQ, int STAGES>
__global__ void __launch_bounds__(TC_THREADS)
flash_dkv_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk,
                    T* __restrict__ dv, int S, int D, int causal,
                    float scale) {
  using M = Mma<T>;
  constexpr int RB = Tile<T, DP>::RB, KTILE = BT * RB, QTILE = BQ * RB;
  constexpr int NQ = BQ / 8, ND = DP / 8;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t s0 = smem_addr(tc_smem);
  const uint32_t stage0 = s0 + 2 * KTILE;             // q, dO of stage 0
  const uint32_t rows0 = stage0 + 2 * STAGES * QTILE;  // lse, delta
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  // Causal: the first key tiles are seen by the most queries; y = 0 starts
  // first.
  const int k0 = blockIdx.y * BT;
  const size_t base = (size_t)blockIdx.x * S * D;
  const size_t rbase = (size_t)blockIdx.x * S;
  const int kdepth = (D + M::KS - 1) / M::KS * M::KS;
  // Causal: queries before this tile's first key see none of it.
  const int q_start = causal ? k0 : 0;
  const int n_q = (S - q_start + BQ - 1) / BQ;

  auto load_stage = [&](int stage, int q0) {
    const uint32_t qs = stage0 + 2 * stage * QTILE;
    load_tile_async<T, DP, BQ>(qs, q + base, q0, S, D);
    load_tile_async<T, DP, BQ>(qs + QTILE, dout + base, q0, S, D);
    load_rows_async<BQ>(rows0 + 8 * BQ * stage, lse + rbase, q0, S);
    load_rows_async<BQ>(rows0 + 8 * BQ * stage + 4 * BQ, delta + rbase, q0,
                        S);
  };
  load_tile_async<T, DP, BT>(s0, k + base, k0, S, D);
  load_tile_async<T, DP, BT>(s0 + KTILE, v + base, k0, S, D);
  load_stage(0, q_start);
  cp_async_commit();

  const int ka = k0 + 16 * warp + g, kb = ka + 8;   // this lane's keys
  const float scale2 = scale * LOG2E;
  float dk_acc[ND][4] = {}, dv_acc[ND][4] = {};

  for (int it = 0; it < n_q; ++it) {
    const int st = STAGES == 2 ? it & 1 : 0;   // as in dq
    if constexpr (STAGES == 2) {
      if (it + 1 < n_q) {
        load_stage(st ^ 1, q_start + (it + 1) * BQ);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      if (it > 0) {
        load_stage(0, q_start + it * BQ);
        cp_async_commit();
      }
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t qs = stage0 + 2 * st * QTILE;
    const float* lse_s =
        reinterpret_cast<const float*>(tc_smem + (rows0 - s0) + 8 * BQ * st);
    const float* delta_s = lse_s + BQ;
    float sT[NQ][4] = {}, dpT[NQ][4] = {};
    mma_abt<T, DP, NQ>(sT, s0 + 16 * warp * RB, qs, kdepth, lane);
    mma_abt<T, DP, NQ>(dpT, s0 + KTILE + 16 * warp * RB, qs + QTILE, kdepth,
                       lane);
    const int q0 = q_start + it * BQ;
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = e < 2 ? ka : kb;
        const int c = 8 * j + 2 * t + (e & 1);
        const int col = q0 + c;
        const bool dead = col >= S || key >= S || (causal && key > col);
        const float p = dead ? 0.f
            : exp2f(fmaf(sT[j][e], scale2, -lse_s[c] * LOG2E));
        sT[j][e] = p;                                 // p^T
        dpT[j][e] = p * (dpT[j][e] - delta_s[c]);     // ds^T
      }
    }
    const unsigned char* qs_gen = tc_smem + (qs - s0);
    mma_pb<T, DP, ND, NQ>(dv_acc, sT, qs_gen + QTILE, qs + QTILE, D, lane);
    mma_pb<T, DP, ND, NQ>(dk_acc, dpT, qs_gen, qs, D, lane);
    __syncthreads();   // the stage is refilled from here on
  }
  store_rows<T, ND>(dk + base, dk_acc, ka, S, D, scale, t);
  store_rows<T, ND>(dv + base, dv_acc, ka, S, D, 1.f, t);
}

// ----------------------------------------------------------------- launch
template <typename T, int DP, int STAGES>
constexpr size_t fwd_tc_smem() { return (1 + 2 * STAGES) * BT * Tile<T, DP>::RB; }
template <typename T, int DP, int STAGES>
constexpr size_t dq_tc_smem() { return (2 + 2 * STAGES) * BT * Tile<T, DP>::RB; }
template <typename T, int DP, int BQ, int STAGES>
constexpr size_t dkv_tc_smem() {
  return (2 * BT + 2 * STAGES * BQ) * Tile<T, DP>::RB + 8 * STAGES * BQ;
}

int check_shape(int BH, int S, int D) {
  if (BH <= 0 || BH > 65535 || S <= 0 || (S + BT - 1) / BT > 65535 ||
      D <= 0 || D > 128 || D % 8 != 0)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// Sets the kernel's dynamic shared memory (above 48 KB needs the opt-in)
// and launches it on the caller's stream; returns the CUDA error, 0 if the
// launch was accepted.
template <typename K, typename... Args>
int launch(K kernel, dim3 grid, int threads, size_t smem, void* stream,
           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return (int)cudaGetLastError();
}

int tiles(int S) { return (S + BT - 1) / BT; }

// The streamed tiles by type, from timings of 64- and 32-row tiles in one
// and two stages at the LM's shape on the card (PERF.md §6). f32 is
// bound by latency more than by shared memory: one stage (70 KB a dq block
// at D = 64, three blocks an SM) beat two, and dk/dv's 32-query tiles beat
// 64. bf16 keeps two stages of 64 rows (one stage was slower); f16 takes
// bf16's tiles, untimed apart. dk/dv takes 32 queries at D > 64 in every
// type (registers). The forward takes the
// same stages; PSK_FLASH_FWD_STAGES overrides them at build time, for
// tools/flash_fwd_stages.py, which times both.
template <typename T> constexpr int stages() {
  return std::is_same<T, float>::value ? 1 : 2;
}
template <typename T> constexpr int fwd_stages() {
#ifdef PSK_FLASH_FWD_STAGES
  return PSK_FLASH_FWD_STAGES;
#else
  return stages<T>();
#endif
}
template <typename T, int DP> constexpr int dkv_bq() {
  return std::is_same<T, float>::value || DP > 64 ? 32 : 64;
}

template <typename T, int DP>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int BH, int S, int D, int causal, float scale, void* stream) {
  constexpr int ST = fwd_stages<T>();
  return launch(flash_fwd_tc_kernel<T, DP, ST>, dim3(BH, tiles(S)),
                TC_THREADS, fwd_tc_smem<T, DP, ST>(), stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<T*>(o),
                static_cast<float*>(lse), S, D, causal, scale);
}

template <typename T, int DP>
int dq(const void* q, const void* k, const void* v, const void* dout,
       const void* lse, const void* delta, void* dq_out, int BH, int S, int D,
       int causal, float scale, void* stream) {
  constexpr int ST = stages<T>();
  return launch(flash_dq_tc_kernel<T, DP, ST>, dim3(BH, tiles(S)),
                TC_THREADS, dq_tc_smem<T, DP, ST>(), stream,
                static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const T*>(dout), static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<T*>(dq_out), S,
                D, causal, scale);
}

// dk/dv loops over 64 query rows at a time, 32 at D > 64 (registers).
template <typename T, int DP>
int dkv(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dk, void* dv, int BH, int S,
        int D, int causal, float scale, void* stream) {
  constexpr int BQ = dkv_bq<T, DP>(), ST = stages<T>();
  return launch(flash_dkv_tc_kernel<T, DP, BQ, ST>, dim3(BH, tiles(S)),
                TC_THREADS, dkv_tc_smem<T, DP, BQ, ST>(), stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const T*>(dout),
                static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<T*>(dk),
                static_cast<T*>(dv), S, D, causal, scale);
}

// Head dims up to 16, 32, 64 and 128: tiles padded to 16, 32, 64 or 128
// columns.
template <typename T>
int fwd_any(const void* q, const void* k, const void* v, void* o, void* lse,
            int BH, int S, int D, int causal, float scale, void* stream) {
  if (int e = check_shape(BH, S, D)) return e;
  if (D <= 16) return fwd<T, 16>(q, k, v, o, lse, BH, S, D, causal, scale, stream);
  if (D <= 32) return fwd<T, 32>(q, k, v, o, lse, BH, S, D, causal, scale, stream);
  if (D <= 64) return fwd<T, 64>(q, k, v, o, lse, BH, S, D, causal, scale, stream);
  return fwd<T, 128>(q, k, v, o, lse, BH, S, D, causal, scale, stream);
}

template <typename T>
int dq_any(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq_out, int BH, int S,
           int D, int causal, float scale, void* stream) {
  if (int e = check_shape(BH, S, D)) return e;
  if (D <= 16)
    return dq<T, 16>(q, k, v, dout, lse, delta, dq_out, BH, S, D, causal, scale, stream);
  if (D <= 32)
    return dq<T, 32>(q, k, v, dout, lse, delta, dq_out, BH, S, D, causal, scale, stream);
  if (D <= 64)
    return dq<T, 64>(q, k, v, dout, lse, delta, dq_out, BH, S, D, causal, scale, stream);
  return dq<T, 128>(q, k, v, dout, lse, delta, dq_out, BH, S, D, causal, scale, stream);
}

template <typename T>
int dkv_any(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv, int BH,
            int S, int D, int causal, float scale, void* stream) {
  if (int e = check_shape(BH, S, D)) return e;
  if (D <= 16)
    return dkv<T, 16>(q, k, v, dout, lse, delta, dk, dv, BH, S, D, causal, scale, stream);
  if (D <= 32)
    return dkv<T, 32>(q, k, v, dout, lse, delta, dk, dv, BH, S, D, causal, scale, stream);
  if (D <= 64)
    return dkv<T, 64>(q, k, v, dout, lse, delta, dk, dv, BH, S, D, causal, scale, stream);
  return dkv<T, 128>(q, k, v, dout, lse, delta, dk, dv, BH, S, D, causal, scale, stream);
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

extern "C" int psk_flash_fwd_f16(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int BH, int S, int D,
                                 int causal, float scale, void* stream) {
  return fwd_any<__half>(q, k, v, o, lse, BH, S, D, causal, scale, stream);
}

extern "C" int psk_flash_dq_f16(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq_out, int BH, int S,
                                int D, int causal, float scale, void* stream) {
  return dq_any<__half>(q, k, v, dout, lse, delta, dq_out, BH, S, D, causal,
                        scale, stream);
}

extern "C" int psk_flash_dkv_f16(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv, int BH,
                                 int S, int D, int causal, float scale,
                                 void* stream) {
  return dkv_any<__half>(q, k, v, dout, lse, delta, dk, dv, BH, S, D, causal,
                         scale, stream);
}
