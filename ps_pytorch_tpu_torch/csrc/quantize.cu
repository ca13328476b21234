// Int8 block quantization with stochastic rounding, for Hopper (sm_90a).
//
// Replaces ps_pytorch_tpu/ops/quantize.py:_quant_kernel (the Pallas kernel
// behind _quantize_padded / quantize_int8) together with the absmax reduce
// that the TPU version leaves to an XLA fusion outside the kernel (Mosaic
// forbids scalar VMEM stores; a CUDA block has no such limit). For every
// block of 4096 consecutive elements of the flattened input it computes
//     scale = max(max|x| * (1/127), 1e-30)
//     q     = clip(floor(x / scale + u), -127, 127)  -> int8
// with u the caller's uniform noise in [0, 1) (stochastic rounding, unbiased:
// E[q * scale] = x). Elements past the input's end count as zero, which is
// the reference's zero padding to a multiple of 4096 without a padded copy.
//
// What bounds it on this card: bytes. A launch reads 4 B of x (2 B for
// bfloat16) and 4 B of noise and writes 1 B an element, plus 4 B a block of
// scales: 9 B an element, about 30 us for ResNet-18's 11.17M gradient
// elements at 3.35 TB/s. There is no reuse and no tensor-core work.
//
// Design. One thread block of 256 threads owns one quantization block. Each
// thread loads its 16 elements of x once, as four 16-byte vectors where the
// pointer allows it, and keeps them in registers; the block reduces max|x|
// through warp shuffles and 8 floats of shared memory; thread 0 forms the
// scale and writes it; then every thread divides, adds its noise, floors,
// clamps and stores four packed char4. x is read from device memory once
// (the TPU version reads it twice: once for the absmax, once in the kernel).
//
// Arithmetic. The kernel is bitwise equal to its plain version
// (ops/quantize.py:quantize_int8_reference), values and scales: the scale is
// a float32 multiply by the float32 constant 1/127 (what XLA makes of
// amax / 127.0 under jit), the quotient an IEEE division and the sum an IEEE
// addition, spelled with the _rn intrinsics so that no compiler flag can
// contract or approximate them. A NaN in a block reaches its scale, as in
// the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 4096;           // elements per quantization block
constexpr int kThreads = 256;          // threads per block
constexpr int kVecs = kBlock / (4 * kThreads);  // 4-element groups a thread

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, const float* __restrict__ u,
                signed char* __restrict__ values, float* __restrict__ scales,
                long long n, int vec_ok) {
  __shared__ float warp_max[kThreads / 32];
  __shared__ float block_scale;

  const int tid = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * kBlock;

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

#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const long long i = base + 4LL * (k * kThreads + tid);
    const float4 r = *reinterpret_cast<const float4*>(u + i);
    char4 q;
    q.x = round_one(v[k][0], scale, r.x);
    q.y = round_one(v[k][1], scale, r.y);
    q.z = round_one(v[k][2], scale, r.z);
    q.w = round_one(v[k][3], scale, r.w);
    *reinterpret_cast<char4*>(values + i) = q;
  }
}

template <typename T>
int launch(const void* x, const void* u, void* values, void* scales,
           long long n, long long nblk, void* stream) {
  if (n < 1 || nblk < 1 || nblk > 0x7fffffffLL || n > nblk * kBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec_ok =
      reinterpret_cast<uintptr_t>(x) % Src<T>::kAlign == 0 ? 1 : 0;
  quantize_kernel<T><<<static_cast<unsigned>(nblk), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(u),
      static_cast<signed char*>(values), static_cast<float*>(scales), n,
      vec_ok);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: n elements (float32 or bfloat16), anywhere in device memory. u: noise,
// float32 [nblk * 4096], 16-byte aligned. values: int8 [nblk * 4096], 4-byte
// aligned. scales: float32 [nblk]. Returns the launch's CUDA error code.
extern "C" int psk_quantize_f32(const void* x, const void* u, void* values,
                                void* scales, long long n, long long nblk,
                                void* stream) {
  return launch<float>(x, u, values, scales, n, nblk, stream);
}

extern "C" int psk_quantize_bf16(const void* x, const void* u, void* values,
                                 void* scales, long long n, long long nblk,
                                 void* stream) {
  return launch<__nv_bfloat16>(x, u, values, scales, n, nblk, stream);
}
