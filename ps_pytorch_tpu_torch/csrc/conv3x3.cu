// 3x3 stride-1 SAME convolution, NHWC, for Hopper (sm_90a).
//
// Replaces ps_pytorch_tpu/ops/pallas_conv.py:_conv_kernel (the Pallas
// kernel behind conv3x3 / conv3x3_input_grad / conv3x3_op). It computes
//     out[n,h,w,co] = sum_{dy,dx,c} x[n,h+dy-1,w+dx-1,c] * wt[dy,dx,c,co]
// in NHWC / HWIO, with zero padding outside each image, f32 accumulation,
// and one round-to-nearest-even into the input's type (float, bfloat16 or
// half). A half sum above 65504 rounds to inf, as XLA's convert does: no
// clamp.
// The input gradient of the conv is the same kernel on
// flip(wt,(0,1)).swapaxes(2,3) (ops/conv3x3.py).
//
// What bounds it on this card. At batch 256 each ResNet-18 stride-1 3x3 is
// about 19.3 GFLOP: 0.020 ms a launch at the 989 TFLOP/s bf16 tensor-core
// peak, 0.51 ms for the 26 launches of a training step. The 32x32x64
// geometry also moves about 67 MB in bf16, 0.020 ms at 3.35 TB/s, so it sits
// on the ridge; the deeper ones are bound by operations. In f32 the same
// conv is 0.2885 ms at the 67 TFLOP/s of f32 FMA on the CUDA cores and
// 0.1171 ms as 3xTF32 on the tensor cores (three TF32 products at 495
// TFLOP/s for each f32 one); its bytes, 134 MB at 32x32x64, take 0.040 ms.
//
// Three kernels, picked by shape before the launch (ops/conv3x3.py:route):
//
// conv3x3_tc_kernel, bf16 or f16 with C % 8 == 0, Co % 8 == 0 and 16-byte
// aligned pointers (every ResNet stride-1 3x3). An implicit GEMM on the
// tensor cores: M = output pixels, N = Co, K = 9*C in tap-major order,
// through Hopper's warpgroup product wgmma.mma_async m64nBNk16 (bf16 x
// bf16 or f16 x f16 -> f32, the sums in registers; both 16-bit types run
// at 989 TFLOP/s). The element type is a template parameter: the halo and
// weight layouts, the cp.async ring, the ldmatrix addressing, the swizzle
// and the descriptors are the same bytes for both, and only the wgmma
// instruction's type and the epilogue's rounding differ. The batch is one
// tall image of N*H rows; a block owns TH rows x TW columns of it (TW =
// min(W, 64), TH = BM / TW, so 8x8 and 4x4 images still fill a tile) and
// BN output channels, with 2 warpgroups of BM/2 pixels each. The tile, by
// geometry:
//     BN = 64 for Co <= 64, else 128;
//     BM = 256 where that still makes about a wave of blocks (128 for the
//     132 SMs) and fits in shared memory (not at W = 1), else 128.
// At batch 256: 32x32x64 256 x 64 (1024 blocks), 16x16x128 and 8x8x256
// 256 x 128 (256 and 128 blocks), 4x4x512 128 x 128 (32 x 4 = 128 blocks):
// at each geometry the fastest of the candidate tiles timed on the H100.
// For each chunk of BK = 32 input channels the block copies the tile's halo,
// (TH+2) x (TW+2) pixels x 32 channels, and the 9 taps' weight slices
// w[t, c0:c0+32, co0:co0+BN] into shared memory with 16-byte cp.async, in a
// 2-stage ring: chunk k+1 lands while the tensor cores run chunk k. A (the
// pixels) comes from registers: every tap's fragment is an ldmatrix from
// that one halo, each lane giving the address of its own pixel's shifted
// row, so x is read from device memory about (TH+2)(TW+2)/(TH*TW) =
// 1.3-1.6 times, not 9, and the next step's ldmatrix runs while this
// step's wgmma is in flight. A lane whose tap falls in the padding (outside
// the image, or on the neighbouring image's row of the tall stack) points
// at one row of zeros in shared memory: there is no padded copy of x. B
// (the weights) is read by the tensor cores straight from shared memory
// through a descriptor: N-major 64-channel halves of 128-byte rows in the
// 128-byte swizzle. The halo rows are XOR-swizzled by 16-byte chunk so that
// ldmatrix meets no bank conflicts. TMA's tiled mode cannot gather a halo
// with per-image padding, so cp.async copies both. Channels and pixels past
// C, Co or the image are zero-filled on load (cp.async src-size 0) and
// skipped on store. The epilogue rounds f32 to the element type once
// (__floats2bfloat162_rn, __floats2half2_rn), stages the tile in shared
// memory and writes it with 16-byte stores. Offsets into x, w and out are
// 64-bit.
//
// conv3x3_tf32_kernel, f32 with C % 8 == 0, Co % 8 == 0 and 16-byte
// aligned pointers: the same implicit GEMM as 3xTF32 on wgmma.mma_async
// m64n64k8 (tf32 x tf32 -> f32). The tensor cores read only the top 19
// bits of an f32 operand (TF32, 10 mantissa bits), and one TF32 product
// errs about 2^-11 of each term, above the f32 tolerances. So each operand
// x is split into hi, x with its low 13 bits masked off, and lo = x - hi
// (exact in f32), and every k8 step issues lo_a hi_b, hi_a lo_b and then
// hi_a hi_b into one f32 accumulator, the small terms first: the split of
// csrc/flash_attention.cu. lo is truncated again as it is read and lo_a
// lo_b is left out, so a product errs below 3 * 2^-20 of |a b|, the order
// of the f32 sums' own rounding over K = 9C terms. The tensor cores add
// into their accumulator with truncation toward zero, so a sum kept there
// over all 9C/8 steps drifts toward zero in proportion to K. So the
// accumulator holds one chunk's 18 steps (its first product overwrites
// it: scale-d 0), and after each chunk it is added to a second f32 sum in
// registers (round to nearest): 32 more f32 a thread and tile (212
// registers at BM = 256, no spills); the errors against an f64 conv are
// then the SIMT kernel's (chip_smoke.py's f32 rows).
// tests/test_torch_ops.py emulates this order (the split, each wgmma's sum
// truncated, the chunks' sums rounded) and holds it against the JAX kernel
// at the JAX tests' 1e-5, where one TF32 product fails, and at C = 512 at
// the card tests' 1e-4, where one accumulator over all of K fails. The
// layout is the 16-bit kernel's in 4-byte elements:
//   A (the pixels): the same halo in chunks of BK = 16 channels, so a halo
//   row is the same 64 bytes in the same swizzle, and the same ldmatrix
//   addresses give the TF32 fragments (a 16-byte row of 4 floats is 4
//   (row, k) elements of 32 bits, the m64nNk8 A layout); each fragment is
//   split in registers, an AND and a subtraction an element, no cvt.
//   B (the weights): TF32 wgmma takes B only K-major from shared memory,
//   so the kernel reads w as [3][3][Co][C] (ops/conv3x3.py lays it out;
//   for the input gradient that is the flip alone). Each tap's 64 x 16
//   tile is 64 rows of 64 bytes in the 64-byte swizzle, chunk ^ ((row >>
//   1) & 3), the halo's; the descriptors step 512 bytes to the next 8
//   rows (SBO) and 32 bytes into each row for the second k8 step. Each
//   thread splits the weight chunks it copied once they have landed: hi
//   in place, lo into a second copy beside it.
// Shared memory: a stage is the halo, (TH+2)(TW+2)+1 rows of 64 bytes
// (22-33 KB at BM = 256), and the 9 taps' hi and lo, 2 x 36,864 bytes. Two
// stages take 189-211 KB of the 227 KB a block may use: one block an SM,
// 2 warpgroups, BN = 64, BM = 256 (128 where 256 would not make a wave,
// or at W = 1, where its halo would not fit). At BK = 32 or BN = 128 the
// weights' hi and lo alone would take 147 KB a stage. The epilogue stores
// the f32 sums from registers with 8-byte stores, no rounding.
//
// conv3x3_simt_kernel, every other shape (the CIFAR stem's C = 3, ragged
// channels, a view off 16 bytes) in f32, bf16 or f16: the first port of
// the kernel, exact f32 FMA on the CUDA cores (67 TFLOP/s). A block
// computes TH*TW <= 64 pixels x 64 channels, 4 x 4 a thread, staging 8
// input channels of the halo and the 9 weight slices at a time in shared
// memory as f32. 16-bit values convert through the intrinsics only
// (__bfloat162float, __half2float, __float2half_rn), never __half
// arithmetic.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <type_traits>

namespace {

// ------------------------------------------------------------------ SIMT --

namespace simt {

constexpr int BM = 64;                 // output pixels per block
constexpr int BN = 64;                 // output channels per block
constexpr int BK = 8;                  // input channels per shared-memory stage
constexpr int TPB = 256;               // threads per block
constexpr int HALO_MAX = 3 * (BM + 2); // max (TH+2)*(TW+2) over TH*TW <= BM

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f32<__half>(__half v) {
  return __half2float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA's convert
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);  // the same; above 65504 it is inf
}

template <typename T>
__global__ void __launch_bounds__(TPB)
conv3x3_simt_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ out, int N, int H, int W, int C, int Co,
                    int TH, int TW) {
  __shared__ __align__(16) float xs[HALO_MAX * BK];  // [(TH+2)*(TW+2)][BK]
  __shared__ __align__(16) float ws[9 * BK * BN];    // [tap][k][BN]

  const int tid = threadIdx.x;
  const int tx = tid % 16;             // channels co0 + 4*tx .. +3
  const int ty = tid / 16;             // pixels ty + 16*i, i = 0..3
  const int col_tiles = (W + TW - 1) / TW;
  const int row0 = (blockIdx.x / col_tiles) * TH;  // first row of N*H
  const int col0 = (blockIdx.x % col_tiles) * TW;
  const int co0 = blockIdx.y * BN;
  const int rows = N * H;
  const int HW2 = TW + 2;
  const int halo = (TH + 2) * HW2;

  // This thread's 4 pixels: tile row/col, image row, and whether the pixel
  // exists (tile may overhang the image's last rows or columns).
  int pr[4], pc[4], ph[4];
  bool pv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = ty + 16 * i;
    pr[i] = p / TW;
    pc[i] = p % TW;
    const int r = row0 + pr[i];
    pv[i] = p < TH * TW && r < rows && col0 + pc[i] < W;
    ph[i] = pv[i] ? r % H : 0;
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += BK) {
    for (int e = tid; e < halo * BK; e += TPB) {
      const int k = e % BK, q = e / BK;
      const int r = row0 + q / HW2 - 1, col = col0 + q % HW2 - 1, ch = c0 + k;
      float v = 0.f;
      if (r >= 0 && r < rows && col >= 0 && col < W && ch < C)
        v = to_f32(x[((size_t)r * W + col) * C + ch]);
      xs[e] = v;
    }
    for (int e = tid; e < 9 * BK * BN; e += TPB) {
      const int n = e % BN, k = (e / BN) % BK, t = e / (BN * BK);
      const int ch = c0 + k, co = co0 + n;
      float v = 0.f;
      if (ch < C && co < Co) v = to_f32(w[((size_t)t * C + ch) * Co + co]);
      ws[e] = v;
    }
    __syncthreads();
#pragma unroll 1
    for (int t = 0; t < 9; ++t) {
      const int dy = t / 3, dx = t % 3;
      int base[4];
      bool ok[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // Row h+dy-1 outside [0, H) is padding, also where the tall image
        // holds the neighbouring image's row there.
        const int hh = ph[i] + dy - 1;
        ok[i] = pv[i] && hh >= 0 && hh < H;
        base[i] = ok[i] ? ((pr[i] + dy) * HW2 + pc[i] + dx) * BK : 0;
      }
#pragma unroll
      for (int kk = 0; kk < BK; kk += 4) {
        float4 a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = ok[i] ? *reinterpret_cast<const float4*>(&xs[base[i] + kk])
                       : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          b[k] = *reinterpret_cast<const float4*>(
              &ws[(t * BK + kk + k) * BN + 4 * tx]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float av[4] = {a[i].x, a[i].y, a[i].z, a[i].w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            acc[i][0] = fmaf(av[k], b[k].x, acc[i][0]);
            acc[i][1] = fmaf(av[k], b[k].y, acc[i][1]);
            acc[i][2] = fmaf(av[k], b[k].z, acc[i][2]);
            acc[i][3] = fmaf(av[k], b[k].w, acc[i][3]);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!pv[i]) continue;
    const size_t o = ((size_t)(row0 + pr[i]) * W + col0 + pc[i]) * Co;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + 4 * tx + j;
      if (co < Co) out[o + co] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, int N, int H, int W,
           int C, int Co, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0)
    return (int)cudaErrorInvalidValue;
  const int TW = W < BM ? W : BM;
  const int TH = BM / TW;
  const long long row_tiles = ((long long)N * H + TH - 1) / TH;
  const long long col_tiles = (W + TW - 1) / TW;
  const long long blocks = row_tiles * col_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks, (unsigned)((Co + BN - 1) / BN));
  conv3x3_simt_kernel<T><<<grid, TPB, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      N, H, W, C, Co, TH, TW);
  return (int)cudaGetLastError();
}

}  // namespace simt

// ---------------------------------------------------------- tensor cores --

namespace tc {

constexpr int BK = 32;             // input channels per stage
constexpr int STAGES = 2;          // cp.async ring depth
constexpr int THREADS = 256;       // 2 warpgroups
constexpr int ROW_BYTES = BK * 2;  // one halo pixel's BK channels, 16-bit
constexpr int HALF_BYTES = 9 * BK * 128;  // 64 channels of a chunk's weights
// A block may use 227 KB of the SM's shared memory (H100).
constexpr int MAX_SMEM = 232448;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Make the landed copies visible to the tensor cores' (async) reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from touching accumulators across wgmma_wait.
template <int R> __device__ __forceinline__ void pin(float (&d)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) asm volatile("" : "+f"(d[r])::"memory");
}

// d (64 x N, f32) += a (64 x 16 of T, this warp's 16 rows in registers,
// the mma.m16n8k16 A layout) * B (16 x N of T in shared memory, N-major,
// 128-byte swizzle, described by desc). The instruction names the type, and
// an asm string is a literal: each width is one macro over the type's
// name, instantiated once for bf16 and once for f16.
#define PSK_WGMMA_N64(TY)                                                     \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"            \
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"                \
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"       \
      "}, {%32,%33,%34,%35}, %36, p, 1, 1, 1;\n}\n"                           \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                       \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                       \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                     \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                   \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                   \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                   \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                   \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])                    \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1))

#define PSK_WGMMA_N128(TY)                                                    \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"           \
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"                \
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"      \
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"      \
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"       \
      "}, {%64,%65,%66,%67}, %68, p, 1, 1, 1;\n}\n"                           \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                       \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                       \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                     \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                   \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                   \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                   \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                   \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),                   \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),                   \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),                   \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),                   \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),                   \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),                   \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),                   \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),                   \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                    \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1))

template <typename T, int BN>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2],
                                      const unsigned (&a)[4],
                                      unsigned long long desc) {
  constexpr bool f16 = std::is_same<T, __half>::value;
  if constexpr (BN == 64) {
    if constexpr (f16) PSK_WGMMA_N64("f16"); else PSK_WGMMA_N64("bf16");
  } else {
    if constexpr (f16) PSK_WGMMA_N128("f16"); else PSK_WGMMA_N128("bf16");
  }
}

// Two f32 sums rounded once to the element type, stored as one pair.
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// Byte offset of 16-byte chunk kc (channels 8kc..8kc+7) of halo row r: a
// row is 64 bytes, and chunk kc sits at kc ^ ((r >> 1) & 3), so any 8
// consecutive rows fill all 32 banks.
__device__ __forceinline__ unsigned a_off(int r, int kc) {
  return r * ROW_BYTES + ((kc ^ ((r >> 1) & 3)) << 4);
}
// Byte offset of 16-byte chunk nc (channels 8nc..8nc+7) of weight row `row`
// (= tap * BK + k): each 64-channel half is its own [9*BK][64] block of
// 128-byte rows, chunk nc % 8 at (nc % 8) ^ (row % 8): the 128-byte swizzle
// of wgmma's N-major operand.
__device__ __forceinline__ unsigned b_off(int row, int nc) {
  return (nc >> 3) * HALF_BYTES + row * 128 + (((nc & 7) ^ (row & 7)) << 4);
}
// wgmma descriptor of the 16 x BN slice of B starting at row address addr:
// 128-byte swizzle, the next 8 rows (k) 1024 bytes on, the next 64 columns
// (n) one half on.
__device__ __forceinline__ unsigned long long b_desc(unsigned addr) {
  return (unsigned long long)((addr >> 4) & 0x3FFF) |
         ((unsigned long long)(HALF_BYTES >> 4) << 16) |
         ((unsigned long long)(1024 >> 4) << 32) | (1ull << 62);
}

// The block's place in the batch, one tall image of N*H rows: its first
// row and column, and its halo, (TH+2) x (TW+2) pixels; row `halo` of a
// stage is a row of zeros, the one a tap in the padding reads.
struct Tile {
  int HW2, halo, rows, row0, col0;
  __device__ __forceinline__ Tile(int N, int H, int W, int TH, int TW) {
    HW2 = TW + 2;
    halo = (TH + 2) * HW2;
    rows = N * H;
    const int col_tiles = (W + TW - 1) / TW;
    row0 = (blockIdx.x / col_tiles) * TH;
    col0 = (blockIdx.x % col_tiles) * TW;
  }
};

// The ring's start in dynamic shared memory, aligned to the 1024-byte
// swizzle atom, with the zero row of each stage written.
__device__ __forceinline__ unsigned char* ring(unsigned char* smem_raw,
                                               const Tile& tl, int tid,
                                               int stage_bytes) {
  unsigned char* smem =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  if (tid < 4 * STAGES)
    *reinterpret_cast<uint4*>(smem + (tid >> 2) * stage_bytes +
                              tl.halo * ROW_BYTES + (tid & 3) * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  return smem;
}

// This lane's pixel in each of its MT m64 tiles (the ldmatrix row it
// addresses): its halo row for tap (0,0) and a mask of the taps that read
// inside its own image. Warpgroup wg owns pixels [wg*BM/2, (wg+1)*BM/2),
// warp wq of it the 16 rows wq*16.. of each m64 tile.
template <int MT>
__device__ __forceinline__ void lane_pixels(const Tile& tl, int H, int W,
                                            int TH, int TW, int wg, int wq,
                                            int lane, int (&a_base)[MT],
                                            unsigned (&a_mask)[MT]) {
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int p = wg * (MT * 64) + i * 64 + wq * 16 + (lane & 15);
    const int pr = p / TW, pc = p % TW;
    const int r = tl.row0 + pr, col = tl.col0 + pc;
    const bool pv = pr < TH && r < tl.rows && col < W;
    const int h = pv ? r % H : 0;
    unsigned m = 0;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int hh = h + t / 3 - 1, ww = col + t % 3 - 1;
      if (pv && hh >= 0 && hh < H && ww >= 0 && ww < W) m |= 1u << t;
    }
    a_base[i] = pr * tl.HW2 + pc;
    a_mask[i] = m;
  }
}

// Copy one chunk of the halo into the stage at sa: 64 bytes a pixel,
// channels c0.. (32 of a 16-bit type, 16 of f32), thread tid copying the
// 16-byte piece tid & 3 of every fourth row.
template <typename T>
__device__ __forceinline__ void load_halo(unsigned sa, const T* x,
                                          const Tile& tl, int W, int C,
                                          int c0, int tid) {
  const int kc = tid & 3;
  const int ch = c0 + kc * (16 / (int)sizeof(T));
  for (int q = tid >> 2; q < tl.halo; q += THREADS / 4) {
    const int r = tl.row0 - 1 + q / tl.HW2, col = tl.col0 - 1 + q % tl.HW2;
    const bool ok = ch < C && r >= 0 && r < tl.rows && col >= 0 && col < W;
    const T* src = ok ? x + (((long long)r * W + col) * C + ch) : x;
    cp_async16(sa + a_off(q, kc), src, ok);
  }
}

// The A fragment of tap t (halo offset toff) and k step ks: an ldmatrix
// from the lane's shifted halo row, or from the zero row in the padding.
__device__ __forceinline__ void load_a(unsigned (&v)[4], unsigned sa,
                                       int base, unsigned mask, int t,
                                       int toff, int halo, int ks, int lane) {
  const int r = (mask >> t) & 1u ? base + toff : halo;
  ldmatrix_x4(v, sa + a_off(r, ks * 2 + (lane >> 4)));
}

// One block: BM pixels x BN channels, BM/128 m64 tiles a warpgroup.
// Two 128 x 64 blocks fit an SM (126 registers, 99 KB of shared memory at
// 32x32); every larger tile takes one.
template <typename T, int BM, int BN>
__global__ void __launch_bounds__(THREADS, BM * BN <= 128 * 64 ? 2 : 1)
conv3x3_tc_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  T* __restrict__ out, int N, int H, int W, int C, int Co,
                  int TH, int TW, int a_bytes) {
  constexpr int MT = BM / 128;            // m64 tiles a warpgroup
  constexpr int NACC = BN / 2;            // f32 sums a thread per m64 tile
  constexpr int NC = BN / 8;              // 16-byte chunks in a weight row
  constexpr int B_BYTES = (BN / 64) * HALF_BYTES;
  extern __shared__ unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3;
  const int stage_bytes = a_bytes + B_BYTES;
  const Tile tl(N, H, W, TH, TW);
  const int co0 = blockIdx.y * BN;
  unsigned char* smem = ring(smem_raw, tl, tid, stage_bytes);
  int a_base[MT];
  unsigned a_mask[MT];
  lane_pixels(tl, H, W, TH, TW, wg, wq, lane, a_base, a_mask);

  // Copy chunk c0 (channels c0..c0+BK-1) of the halo and of the 9 weight
  // slices into stage s.
  auto load_stage = [&](int s, int c0) {
    const unsigned sa = smem_u32(smem + s * stage_bytes);
    const unsigned sb = sa + a_bytes;
    load_halo(sa, x, tl, W, C, c0, tid);
    const int nc = tid % NC;
    const int co = co0 + nc * 8;
    for (int row = tid / NC; row < 9 * BK; row += THREADS / NC) {
      const int t = row / BK, c = c0 + row % BK;
      const bool ok = co < Co && c < C;
      const T* src = ok ? w + (((long long)t * C + c) * Co + co) : w;
      cp_async16(sb + b_off(row, nc), src, ok);
    }
  };

  float acc[MT][NACC];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int v = 0; v < NACC; ++v) acc[i][v] = 0.f;

  const int chunks = (C + BK - 1) / BK;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < chunks; ++kt) {
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();  // chunk kt is in; stage (kt+1)%2 is free again
    if (kt + 1 < chunks) load_stage((kt + 1) % STAGES, (kt + 1) * BK);
    cp_async_commit();
    const unsigned sa = smem_u32(smem + (kt % STAGES) * stage_bytes);
    const unsigned sb = sa + a_bytes;
    // 9 taps x 2 k16 steps. A is double-buffered in registers: the
    // ldmatrix of step s+1 runs while the wgmma of step s is in flight.
    unsigned af[2][MT][4];
#pragma unroll
    for (int step = 0; step < 9 * BK / 16; ++step) {
      const int t = step / (BK / 16), ks = step % (BK / 16);
      const int toff = (t / 3) * tl.HW2 + t % 3;
#pragma unroll
      for (int i = 0; i < MT; ++i)
        load_a(af[step & 1][i], sa, a_base[i], a_mask[i], t, toff, tl.halo,
               ks, lane);
      wgmma_fence();
      const unsigned long long desc = b_desc(sb + (t * BK + ks * 16) * 128);
#pragma unroll
      for (int i = 0; i < MT; ++i)
        wgmma<T, BN>(acc[i], af[step & 1][i], desc);
      wgmma_commit();
      wgmma_wait<1>();
    }
    wgmma_wait<0>();  // the stage is read before the next chunk lands in it
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) pin(acc[i]);

  // Epilogue: f32 -> T once, staged as a [BM][BN+8] tile in shared
  // memory, then 16-byte stores of whole 8-channel chunks. Sum 4j..4j+3 of
  // a thread is (row g, columns 8j+2q, +1) and (row g+8, the same).
  cp_async_wait_all();
  __syncthreads();
  constexpr int CS = BN + 8;
  T* cs = reinterpret_cast<T*>(smem);
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int r = wg * (BM / 2) + i * 64 + wq * 16 + g, c = j * 8 + q * 2;
      store_pair(&cs[r * CS + c], acc[i][4 * j], acc[i][4 * j + 1]);
      store_pair(&cs[(r + 8) * CS + c], acc[i][4 * j + 2], acc[i][4 * j + 3]);
    }
  __syncthreads();
  for (int e = tid; e < BM * NC; e += THREADS) {
    const int p = e / NC, nc = e % NC;
    const int pr = p / TW, pc = p % TW;
    const int r = tl.row0 + pr, col = tl.col0 + pc, co = co0 + nc * 8;
    if (pr < TH && r < tl.rows && col < W && co < Co)
      *reinterpret_cast<uint4*>(out + (((long long)r * W + col) * Co + co)) =
          *reinterpret_cast<const uint4*>(&cs[p * CS + nc * 8]);
  }
}

// ------------------------------------------------ tensor cores, f32 --

constexpr int F32_BK = 16;                    // f32 channels a 64-byte row
constexpr int F32_BN = 64;                    // output channels a block
constexpr int F32_TAP_BYTES = F32_BN * ROW_BYTES;  // a tap's 64 x 16 tile
constexpr int F32_B_BYTES = 9 * F32_TAP_BYTES;     // 9 taps: hi, or lo

// d (64 x 64, f32) = a (64 x 8 TF32, this warp's 16 rows in registers:
// (g, t), (g+8, t), (g, t+4), (g+8, t+4) for lane 4g + t) * B (8 x 64
// TF32 in shared memory, K-major, described by desc), plus d where
// accumulate is not 0. TF32 takes no transpose immediates.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const unsigned (&a)[4],
                                           unsigned long long desc,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
      "}, {%32,%33,%34,%35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

// wgmma descriptor of the 8 x 64 K-major slice of B whose first row of k
// starts at addr: 64-byte swizzle, the next 8 rows (n) 512 bytes on; LBO
// is not read in a swizzled K-major layout.
__device__ __forceinline__ unsigned long long kmajor_desc(unsigned addr) {
  return (unsigned long long)((addr >> 4) & 0x3FFF) | (1ull << 16) |
         ((unsigned long long)((8 * ROW_BYTES) >> 4) << 32) | (2ull << 62);
}

// hi: x with its low 13 bits masked off (TF32); lo = x - hi, exact in f32.
__device__ __forceinline__ void split_tf32(unsigned v, unsigned& hi,
                                           unsigned& lo) {
  hi = v & 0xFFFFE000u;
  lo = __float_as_uint(__uint_as_float(v) - __uint_as_float(hi));
}

// One block: BM pixels x 64 channels, as conv3x3_tc_kernel's tile; wk is
// the weight in K-major order [3][3][Co][C].
template <int BM>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_tf32_kernel(const float* __restrict__ x, const float* __restrict__ wk,
                    float* __restrict__ out, int N, int H, int W, int C,
                    int Co, int TH, int TW, int a_bytes) {
  constexpr int MT = BM / 128;            // m64 tiles a warpgroup
  extern __shared__ unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3;
  const int stage_bytes = a_bytes + 2 * F32_B_BYTES;
  const Tile tl(N, H, W, TH, TW);
  const int co0 = blockIdx.y * F32_BN;
  const int kc = tid & 3;                 // the 16-byte chunk this thread
                                          // copies of every weight row
  unsigned char* smem = ring(smem_raw, tl, tid, stage_bytes);
  int a_base[MT];
  unsigned a_mask[MT];
  lane_pixels(tl, H, W, TH, TW, wg, wq, lane, a_base, a_mask);

  // Copy chunk c0 (channels c0..c0+15) of the halo and of the 9 taps'
  // K-major weight tiles (row t * 64 + n: wk[t][co0 + n][c0..c0+15]) into
  // stage s; the weights land in the hi copy.
  auto load_stage = [&](int s, int c0) {
    const unsigned sa = smem_u32(smem + s * stage_bytes);
    const unsigned sb = sa + a_bytes;
    const int ch = c0 + kc * 4;
    load_halo(sa, x, tl, W, C, c0, tid);
    for (int row = tid >> 2; row < 9 * F32_BN; row += THREADS / 4) {
      const int t = row / F32_BN, co = co0 + row % F32_BN;
      const bool ok = co < Co && ch < C;
      const float* src = ok ? wk + (((long long)t * Co + co) * C + ch) : wk;
      cp_async16(sb + a_off(row, kc), src, ok);
    }
  };
  // Split the weight chunks this thread copied into stage s, landed: hi in
  // place, lo at the same offset of the lo copy.
  auto split_stage = [&](int s) {
    unsigned char* b = smem + s * stage_bytes + a_bytes;
    for (int row = tid >> 2; row < 9 * F32_BN; row += THREADS / 4) {
      uint4* hp = reinterpret_cast<uint4*>(b + a_off(row, kc));
      uint4 v = *hp, hi, lo;
      split_tf32(v.x, hi.x, lo.x);
      split_tf32(v.y, hi.y, lo.y);
      split_tf32(v.z, hi.z, lo.z);
      split_tf32(v.w, hi.w, lo.w);
      *hp = hi;
      *reinterpret_cast<uint4*>(b + F32_B_BYTES + a_off(row, kc)) = lo;
    }
  };

  // acc: one chunk's sums, in the tensor cores' accumulator; sum: the
  // chunks' sums, added in f32 (round to nearest) after each chunk.
  float acc[MT][32], sum[MT][32];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int v = 0; v < 32; ++v) sum[i][v] = acc[i][v] = 0.f;

  const int chunks = (C + F32_BK - 1) / F32_BK;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < chunks; ++kt) {
    cp_async_wait_all();
    split_stage(kt % STAGES);
    fence_proxy_async();
    __syncthreads();  // chunk kt is in and split; stage (kt+1)%2 is free
    if (kt + 1 < chunks) load_stage((kt + 1) % STAGES, (kt + 1) * F32_BK);
    cp_async_commit();
    const unsigned sa = smem_u32(smem + (kt % STAGES) * stage_bytes);
    const unsigned sb = sa + a_bytes;
    // 9 taps x 2 k8 steps. A is double-buffered in registers, hi and lo:
    // the ldmatrix and split of step s+1 run while the wgmmas of step s
    // are in flight.
    unsigned ah[2][MT][4], al[2][MT][4];
#pragma unroll
    for (int step = 0; step < 9 * F32_BK / 8; ++step) {
      const int t = step / (F32_BK / 8), ks = step % (F32_BK / 8);
      const int toff = (t / 3) * tl.HW2 + t % 3;
      const int bf = step & 1;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        unsigned v[4];
        load_a(v, sa, a_base[i], a_mask[i], t, toff, tl.halo, ks, lane);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          split_tf32(v[j], ah[bf][i][j], al[bf][i][j]);
      }
      wgmma_fence();
      const unsigned b = sb + t * F32_TAP_BYTES + ks * 32;
      const unsigned long long b_hi = kmajor_desc(b);
      const unsigned long long b_lo = kmajor_desc(b + F32_B_BYTES);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        wgmma_tf32(acc[i], al[bf][i], b_hi, step != 0);
        wgmma_tf32(acc[i], ah[bf][i], b_lo, 1);
        wgmma_tf32(acc[i], ah[bf][i], b_hi, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();
    }
    wgmma_wait<0>();  // the stage is read before the next chunk lands in it
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      pin(acc[i]);
#pragma unroll
      for (int v = 0; v < 32; ++v) sum[i][v] += acc[i][v];
    }
  }

  // Epilogue: sum 4j..4j+3 of a thread is (row g, columns 8j+2q, +1) and
  // (row g+8, the same); each pair is one 8-byte store.
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = wg * (BM / 2) + i * 64 + wq * 16 + g + 8 * half;
      const int pr = p / TW, pc = p % TW;
      const int r = tl.row0 + pr, col = tl.col0 + pc;
      if (pr >= TH || r >= tl.rows || col >= W) continue;
      float* o = out + (((long long)r * W + col) * Co + co0 + q * 2);
#pragma unroll
      for (int j = 0; j < F32_BN / 8; ++j)
        if (co0 + j * 8 + q * 2 < Co)
          *reinterpret_cast<float2*>(o + j * 8) =
              make_float2(sum[i][4 * j + 2 * half],
                          sum[i][4 * j + 2 * half + 1]);
    }
}

// Dynamic shared memory of one block of the BM x BN tile at image width W:
// the ring's 2 stages (halo and zero row, rounded to 1024 bytes, then the
// weight slices: in f32 their hi and lo copies) or the 16-bit epilogue's
// staged tile, whichever is larger, plus 1024 bytes to align the ring.
template <typename T, int BM, int BN>
int smem_bytes(int W, int* a_bytes) {
  constexpr bool f32 = std::is_same<T, float>::value;
  const int TW = W < 64 ? W : 64;
  const int halo = (BM / TW + 2) * (TW + 2);
  *a_bytes = ((halo + 1) * ROW_BYTES + 1023) / 1024 * 1024;
  const int ring = STAGES * (*a_bytes + (f32 ? 2 * F32_B_BYTES
                                             : (BN / 64) * HALF_BYTES));
  const int tile = f32 ? 0 : BM * (BN + 8) * 2;
  return (ring > tile ? ring : tile) + 1024;
}

template <typename T, int BM, int BN>
int launch(const void* x, const void* w, void* out, int N, int H, int W,
           int C, int Co, void* stream) {
  void (*kernel)(const T*, const T*, T*, int, int, int, int, int, int, int,
                 int);
  if constexpr (std::is_same<T, float>::value)
    kernel = conv3x3_tf32_kernel<BM>;
  else
    kernel = conv3x3_tc_kernel<T, BM, BN>;
  int a_bytes = 0;
  const int smem = smem_bytes<T, BM, BN>(W, &a_bytes);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const int TW = W < 64 ? W : 64;
  const int TH = BM / TW;
  const long long row_tiles = ((long long)N * H + TH - 1) / TH;
  const long long blocks = row_tiles * ((W + TW - 1) / TW);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  // Raise the kernel's shared-memory limit once per device, so a launch
  // costs no driver call beyond itself.
  static std::atomic<bool> ready[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[dev].load()) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return (int)err;
    ready[dev].store(true);
  }
  const dim3 grid((unsigned)blocks, (unsigned)((Co + BN - 1) / BN));
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), N, H, W, C, Co, TH, TW, a_bytes);
  return (int)cudaGetLastError();
}

// The tile, from the tables in the header.
template <typename T, int BN>
int launch_bn(const void* x, const void* w, void* out, int N, int H, int W,
              int C, int Co, void* stream) {
  const long long pixels = (long long)N * H * W;
  int unused = 0;
  if ((pixels + 255) / 256 * ((Co + BN - 1) / BN) >= 128 &&
      smem_bytes<T, 256, BN>(W, &unused) <= MAX_SMEM)
    return launch<T, 256, BN>(x, w, out, N, H, W, C, Co, stream);
  return launch<T, 128, BN>(x, w, out, N, H, W, C, Co, stream);
}

// The shape and alignment checks of the tensor-core kernels, then the tile.
template <typename T>
int launch_any(const void* x, const void* w, void* out, int N, int H, int W,
               int C, int Co, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0 || C % 8 || Co % 8 ||
      (reinterpret_cast<unsigned long long>(x) |
       reinterpret_cast<unsigned long long>(w) |
       reinterpret_cast<unsigned long long>(out)) % 16 ||
      (long long)N * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if constexpr (std::is_same<T, float>::value)
    return launch_bn<float, F32_BN>(x, w, out, N, H, W, C, Co, stream);
  else
    return Co <= 64 ? launch_bn<T, 64>(x, w, out, N, H, W, C, Co, stream)
                    : launch_bn<T, 128>(x, w, out, N, H, W, C, Co, stream);
}

}  // namespace tc

}  // namespace

extern "C" int psk_conv3x3_f32_simt(const void* x, const void* w, void* out,
                                    int N, int H, int W, int C, int Co,
                                    void* stream) {
  return simt::launch<float>(x, w, out, N, H, W, C, Co, stream);
}

extern "C" int psk_conv3x3_bf16_simt(const void* x, const void* w, void* out,
                                     int N, int H, int W, int C, int Co,
                                     void* stream) {
  return simt::launch<__nv_bfloat16>(x, w, out, N, H, W, C, Co, stream);
}

extern "C" int psk_conv3x3_f16_simt(const void* x, const void* w, void* out,
                                    int N, int H, int W, int C, int Co,
                                    void* stream) {
  return simt::launch<__half>(x, w, out, N, H, W, C, Co, stream);
}

// The tensor-core kernels. Each takes C % 8 == 0, Co % 8 == 0 and 16-byte
// aligned pointers, and refuses anything else (cudaErrorInvalidValue): the
// caller picks the kernel by shape before the launch. The f32 one reads
// its weight K-major, wk[3][3][Co][C]; the 16-bit ones read w[3][3][C][Co].
extern "C" int psk_conv3x3_f32(const void* x, const void* wk, void* out,
                               int N, int H, int W, int C, int Co,
                               void* stream) {
  return tc::launch_any<float>(x, wk, out, N, H, W, C, Co, stream);
}

extern "C" int psk_conv3x3_bf16(const void* x, const void* w, void* out, int N,
                                int H, int W, int C, int Co, void* stream) {
  return tc::launch_any<__nv_bfloat16>(x, w, out, N, H, W, C, Co, stream);
}

extern "C" int psk_conv3x3_f16(const void* x, const void* w, void* out, int N,
                               int H, int W, int C, int Co, void* stream) {
  return tc::launch_any<__half>(x, w, out, N, H, W, C, Co, stream);
}
