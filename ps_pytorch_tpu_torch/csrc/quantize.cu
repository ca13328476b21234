// Int8 block quantization with stochastic rounding, for Hopper (sm_90a):
// one launch quantizes a whole gradient tree.
//
// Replaces ps_pytorch_tpu/ops/quantize.py:_quant_kernel (the Pallas kernel
// behind _quantize_padded / quantize_int8, called once a leaf by the JAX
// aggregator, parallel/async_dp.py) together with the absmax reduce that
// the TPU version leaves to an XLA fusion outside the kernel (Mosaic
// forbids scalar VMEM stores; a CUDA block has no such limit) and the
// uniform draw of each leaf's noise. For every leaf of the tree, flattened
// and cut into blocks of 4096 consecutive elements, it computes
//     scale = max(max|x| * (1/127), 1e-30)      once a block
//     q     = clip(floor(x / scale + u), -127, 127)  -> int8
// with u uniform noise in [0, 1) (stochastic rounding, unbiased:
// E[q * scale] = x). Elements past a leaf's end count as zero, which is the
// reference's zero padding to a multiple of 4096 without a padded copy.
//
// The noise. Either the caller's (an f32 tensor a leaf, as the reference
// takes it; the tests inject the JAX package's draws that way), or drawn
// here by Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as
// 1, 2, 3", SC 2011), the counter-based generator that takes the place of
// the TPU's in-kernel random bits: key (k0, k1), the launch's (for the
// aggregator: slice id and step); counter (element index / 4, leaf index,
// 0, 0), whose four output words are the bits of elements 4c .. 4c + 3 of
// that leaf; u = (bits >> 8) * 2^-24, exact in f32. The stream of a leaf
// depends on the key, its index and nothing else: not on how the tree is
// split into launches, nor on the device. The plain version
// (ops/quantize.py:philox_uniform) computes the same bits with integer
// tensor ops.
//
// What bounds it on this card: bytes. With the noise drawn here a launch
// reads 4 B of x (2 B for bfloat16) and writes 1 B an element, plus 4 B a
// block of scales: 5 B an element, about 17 us for ResNet-18's 11.17M
// gradient elements at 3.35 TB/s; the caller's noise adds 4 B an element
// (9 B, about 30 us). The Philox rounds cost 20 integer multiplies for 4
// elements, well inside the integer rate at that many bytes.
//
// Design. One launch for the tree: a table of one entry a leaf (below) and
// a block-to-leaf map, both built by the wrapper and copied to the card in
// one transfer, and one int8 values buffer and one f32 scales buffer for
// every leaf's blocks in order; the wrapper hands each leaf its own rows of
// both. One thread block of 256 threads owns one quantization block: it
// reads its leaf's entry through the map, then each thread loads its 16
// elements of x once, as four 16-byte vectors where the leaf's address
// allows it, and keeps them in registers; the block reduces max|x| through
// warp shuffles and 8 floats of shared memory; thread 0 forms the scale and
// writes it; then every thread draws (or loads) its noise four elements at
// a time, divides, adds, floors, clamps and stores four packed char4. x is
// read from device memory once (the TPU version reads it twice: once for
// the absmax, once in the kernel).
//
// Arithmetic. The kernel is bitwise equal to its plain version
// (ops/quantize.py:quantize_tree_reference), values and scales: the scale
// is a float32 multiply by the float32 constant 1/127 (what XLA makes of
// amax / 127.0 under jit), the quotient an IEEE division and the sum an
// IEEE addition, spelled with the _rn intrinsics so that no compiler flag
// can contract or approximate them. A NaN in a block reaches its scale, as
// in the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 4096;           // elements per quantization block
constexpr int kThreads = 256;          // threads per block
constexpr int kVecs = kBlock / (4 * kThreads);  // 4-element groups a thread

// One entry of the launch's leaf table: six 64-bit words, in this order
// (ops/quantize.py:_plan writes them).
struct Leaf {
  const void* x;          // the leaf's elements, float32 or bfloat16
  long long n;            // their count
  const float* noise;     // the caller's noise, f32 [blocks * 4096], or
                          // null: Philox
  long long first_block;  // the leaf's first block in the launch's output
  long long index;        // the leaf's index: the Philox counter's word 1
  long long bf16;         // 1: x is bfloat16; 0: float32
};
static_assert(sizeof(Leaf) == 48, "the wrapper writes six int64 words");

constexpr uint32_t kPhiloxM0 = 0xD2511F53u, kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u, kPhiloxW1 = 0xBB67AE85u;

// Philox4x32-10: ten rounds, the key bumped between rounds.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x), lo0 = kPhiloxM0 * c.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z), lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// The top 24 bits times 2^-24: exact, in [0, 1).
__device__ __forceinline__ float uniform(uint32_t bits) {
  return __fmul_rn(__uint2float_rn(bits >> 8), 5.9604644775390625e-8f);
}

template <typename T> struct Src;
template <> struct Src<float> {
  static constexpr uintptr_t kAlign = 16;
  static __device__ __forceinline__ float one(const float* p) { return *p; }
  static __device__ __forceinline__ void four(const float* p, float v[4]) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  }
};
template <> struct Src<__nv_bfloat16> {
  static constexpr uintptr_t kAlign = 8;
  static __device__ __forceinline__ float one(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void four(const __nv_bfloat16* p,
                                              float v[4]) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    v[0] = __uint_as_float(raw.x << 16);
    v[1] = __uint_as_float(raw.x & 0xffff0000u);
    v[2] = __uint_as_float(raw.y << 16);
    v[3] = __uint_as_float(raw.y & 0xffff0000u);
  }
};

// max that keeps a NaN, as jnp.max and torch.amax do (fmaxf drops it).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ signed char round_one(float x, float scale,
                                                 float u) {
  float q = floorf(__fadd_rn(__fdiv_rn(x, scale), u));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return static_cast<signed char>(static_cast<int>(q));
}

// Block blk of the leaf (its elements [blk * 4096, blk * 4096 + 4096)) into
// the launch's block blockIdx.x of values and scales.
template <typename T>
__device__ __forceinline__ void quantize_block(
    const Leaf& leaf, long long blk, signed char* __restrict__ values,
    float* __restrict__ scales, uint32_t k0, uint32_t k1) {
  __shared__ float warp_max[kThreads / 32];
  __shared__ float block_scale;

  const T* __restrict__ x = static_cast<const T*>(leaf.x);
  const long long n = leaf.n;
  const int tid = threadIdx.x;
  const long long base = blk * kBlock;
  const bool vec_ok = reinterpret_cast<uintptr_t>(x) % Src<T>::kAlign == 0;

  float v[kVecs][4];
  float amax = 0.0f;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const long long i = base + 4LL * (k * kThreads + tid);
    if (vec_ok && i + 4 <= n) {
      Src<T>::four(x + i, v[k]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[k][j] = (i + j < n) ? Src<T>::one(x + i + j) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) amax = nan_max(amax, fabsf(v[k][j]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if ((tid & 31) == 0) warp_max[tid >> 5] = amax;
  __syncthreads();
  if (tid == 0) {
    float m = warp_max[0];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) m = nan_max(m, warp_max[w]);
    float s = __fmul_rn(m, 1.0f / 127.0f);
    s = (s != s) ? s : fmaxf(s, 1e-30f);
    scales[blockIdx.x] = s;
    block_scale = s;
  }
  __syncthreads();
  const float scale = block_scale;

  signed char* out = values + static_cast<long long>(blockIdx.x) * kBlock;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int off = 4 * (k * kThreads + tid);
    const long long i = base + off;              // element within the leaf
    float u[4];
    if (leaf.noise != nullptr) {
      const float4 r = *reinterpret_cast<const float4*>(leaf.noise + i);
      u[0] = r.x; u[1] = r.y; u[2] = r.z; u[3] = r.w;
    } else {
      const uint4 b = philox4x32_10(
          make_uint4(static_cast<uint32_t>(i >> 2),
                     static_cast<uint32_t>(leaf.index), 0u, 0u),
          k0, k1);
      u[0] = uniform(b.x); u[1] = uniform(b.y);
      u[2] = uniform(b.z); u[3] = uniform(b.w);
    }
    char4 q;
    q.x = round_one(v[k][0], scale, u[0]);
    q.y = round_one(v[k][1], scale, u[1]);
    q.z = round_one(v[k][2], scale, u[2]);
    q.w = round_one(v[k][3], scale, u[3]);
    *reinterpret_cast<char4*>(out + off) = q;
  }
}

__global__ void __launch_bounds__(kThreads)
quantize_tree_kernel(const Leaf* __restrict__ leaves,
                     const long long* __restrict__ block_leaf,
                     signed char* __restrict__ values,
                     float* __restrict__ scales, uint32_t k0, uint32_t k1) {
  const Leaf leaf = leaves[block_leaf[blockIdx.x]];
  const long long blk = blockIdx.x - leaf.first_block;
  if (leaf.bf16)
    quantize_block<__nv_bfloat16>(leaf, blk, values, scales, k0, k1);
  else
    quantize_block<float>(leaf, blk, values, scales, k0, k1);
}

}  // namespace

// table: n_leaves Leaf entries (six int64 words each) followed by nblk
// int64 leaf indices, one a block, in device memory, 16-byte aligned; each
// leaf's x anywhere in device memory, its noise (if any) 16-byte aligned.
// values: int8 [nblk * 4096], 4-byte aligned. scales: float32 [nblk].
// (k0, k1): the Philox key. Returns the launch's CUDA error code.
extern "C" int psk_quantize_tree(const void* table, long long n_leaves,
                                 void* values, void* scales, long long nblk,
                                 unsigned int k0, unsigned int k1,
                                 void* stream) {
  if (n_leaves < 1 || nblk < 1 || nblk > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Leaf* leaves = static_cast<const Leaf*>(table);
  quantize_tree_kernel<<<static_cast<unsigned>(nblk), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      leaves, reinterpret_cast<const long long*>(leaves + n_leaves),
      static_cast<signed char*>(values), static_cast<float*>(scales), k0, k1);
  return static_cast<int>(cudaGetLastError());
}
