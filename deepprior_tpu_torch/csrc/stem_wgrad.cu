// The weight gradient of V2V-PoseNet's stem over the occupied voxels (K9).
//
// The stem (models/v2v.py::Stem) is a Conv3d from the occupancy grid, one
// channel, to 16 channels, 7^3 taps, padding 3, stride 1.  Its weight
// gradient is
//   dW[c, k] = sum over samples n and voxels q of x[n, q] dy[n, c, q - k + 3]
// (k a tap, q - k + 3 inside the grid).  Only the set voxels of x add to
// it: a term with x = 0 is exactly zero for a finite dy.  V2V's grid holds
// a hand's visible surface, about 1,200 set voxels of 681,472 a sample at
// 88^3, so the sum over the set voxels takes 0.2% of the dense
// multiply-adds that cuDNN's weight-gradient kernel does.
//
// Replaces no Pallas kernel.  The JAX package leaves the convolution's
// backward to XLA (deepprior_tpu has no V2V-PoseNet), and the port's other
// convolutions stay cuDNN's; this kernel exists because the stem's input is
// sparse by construction and cuDNN's dense pass over it took 37% of the V2V
// train step.
//
// Design: the grid is cut into bricks of 8^3 voxels.
//   1. stem_wgrad_partial: a persistent grid of `blocks` blocks of 352
//      threads, three on each SM; block b takes bricks b, b + blocks, ...
//      in that order.  For each brick its warps stage the brick's 512 x
//      values in shared memory, 32 at a time, with a ballot of the set ones,
//      and the block skips the brick when none is set (a block-wide vote).
//      Otherwise every thread walks the same set bits in order, so no
//      thread diverges over which voxels are set.  Thread t < 343 owns tap
//      t and keeps the 16 channels' sums for it in registers: for a set
//      voxel q it reads dy at q - t + 3 in the 16 channel planes (through L1
//      and L2; neighbouring threads hold neighbouring taps, so a warp reads
//      runs of 7 consecutive values) and adds x[q] times each.  The block
//      writes its 16 x 343 sums to its own row of `partial`.
//   2. stem_wgrad_reduce: one thread per weight sums the rows of `partial`
//      in block order and writes dW in dy's type.
// No atomics, no allocation, no host sync: the result is the same from run
// to run for a given `blocks`.  Sums are float32 whatever the input type.
//
// What bounds it: at the cell's occupancy, neither bytes nor operations.
// The dy it needs is the set voxels' 7^3 neighbourhoods in 16 channels
// (about 10 MB for a batch of 8 at 88^3), x is read once (21.8 MB at
// B = 8, float32), and the multiply-adds are about 53 M: about 0.01 ms at
// the card's 3.35 TB/s.  The scan of x and the latency of the gathers
// from L2 set the time: the persistent grid keeps 33 warps on each SM so
// that their loads overlap, and an empty brick costs one 2 KB read and a
// vote.  A brick's dy halo (14^3 x 16 values) is not staged in shared
// memory: a brick of the cell holds a few tens of set voxels whose windows
// cover a part of the halo, and L1 and L2 keep what neighbouring voxels
// share.  On a full grid the kernel does cuDNN's multiply-adds, its loads
// served by L1 and L2.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libstem_wgrad.so stem_wgrad.cu   (ops/_build.py
//        does this)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 16;          // the stem's output channels
constexpr int kSide = 7;               // taps a side
constexpr int kTaps = kSide * kSide * kSide;  // 343
constexpr int kPad = 3;
constexpr int kWeights = kChannels * kTaps;   // 5,488
constexpr int kBrick = 8;              // a brick is kBrick^3 voxels
constexpr int kBrickVoxels = kBrick * kBrick * kBrick;
constexpr int kChunks = kBrickVoxels / 32;    // a warp's ballot each
constexpr int kThreads = 352;          // 11 warps: one tap a thread, 9 spare
constexpr int kBlocksPerSM = 3;        // ops/hopper_stem.py::BLOCKS launches 3 an SM
constexpr int kReduceThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    stem_wgrad_partial(const T* __restrict__ x, const T* __restrict__ dy,
                       float* __restrict__ partial, int n, int d, int h,
                       int w) {
  __shared__ float xs[kBrickVoxels];
  __shared__ uint32_t set_bits[kChunks];  // bit l of chunk j: voxel 32 j + l is set
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const bool owner = t < kTaps;
  const int kd = t / (kSide * kSide), kh = t / kSide % kSide, kw = t % kSide;
  const int bd = (d + kBrick - 1) / kBrick, bh = (h + kBrick - 1) / kBrick,
            bw = (w + kBrick - 1) / kBrick;
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t dhw = d * hw;
  const int64_t bricks = static_cast<int64_t>(n) * bd * bh * bw;
  float acc[kChannels];
#pragma unroll
  for (int c = 0; c < kChannels; ++c) acc[c] = 0.0f;

  for (int64_t b = blockIdx.x; b < bricks; b += gridDim.x) {
    const int sample = static_cast<int>(b / (bd * bh * bw));
    const int rest = static_cast<int>(b % (bd * bh * bw));
    const int d0 = rest / (bh * bw) * kBrick;
    const int h0 = rest / bw % bh * kBrick;
    const int w0 = rest % bw * kBrick;
    const T* xn = x + sample * dhw;
    // stage the brick's x, 32 voxels (4 rows of 8) a warp at a time, with
    // a ballot of the set ones
    bool any = false;
    for (int j = warp; j < kChunks; j += kThreads / 32) {
      const int i = j * 32 + lane;
      const int qd = d0 + i / (kBrick * kBrick);
      const int qh = h0 + i / kBrick % kBrick;
      const int qw = w0 + i % kBrick;
      float v = 0.0f;
      if (qd < d && qh < h && qw < w) v = to_float(xn[qd * hw + qh * w + qw]);
      xs[i] = v;
      const uint32_t bits = __ballot_sync(0xffffffffu, v != 0.0f);
      if (lane == 0) set_bits[j] = bits;
      any |= bits != 0;
    }
    if (!__syncthreads_or(any)) continue;  // uniform: no thread reads xs
    if (owner) {
      const T* dyn = dy + static_cast<int64_t>(sample) * kChannels * dhw;
      for (int j = 0; j < kChunks; ++j) {
        // the set voxels in order; every thread walks the same bits
        for (uint32_t bits = set_bits[j]; bits != 0; bits &= bits - 1) {
          const int i = j * 32 + __ffs(bits) - 1;
          const float v = xs[i];
          const int od = d0 + i / (kBrick * kBrick) - kd + kPad;
          const int oh = h0 + i / kBrick % kBrick - kh + kPad;
          const int ow = w0 + i % kBrick - kw + kPad;
          if (od < 0 || od >= d || oh < 0 || oh >= h || ow < 0 || ow >= w) continue;
          const T* p = dyn + od * hw + oh * w + ow;
          float g[kChannels];
#pragma unroll
          for (int c = 0; c < kChannels; ++c) g[c] = to_float(p[c * dhw]);
#pragma unroll
          for (int c = 0; c < kChannels; ++c) acc[c] = fmaf(v, g[c], acc[c]);
        }
      }
    }
    __syncthreads();  // the next brick overwrites xs and set_bits
  }
  if (owner) {
    float* row = partial + static_cast<int64_t>(blockIdx.x) * kWeights;
#pragma unroll
    for (int c = 0; c < kChannels; ++c) row[c * kTaps + t] = acc[c];
  }
}

template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
    stem_wgrad_reduce(const float* __restrict__ partial, int blocks,
                      T* __restrict__ out) {
  const int i = blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= kWeights) return;
  float s = 0.0f;
  for (int b = 0; b < blocks; ++b) s += partial[static_cast<int64_t>(b) * kWeights + i];
  out[i] = from_float<T>(s);
}

template <typename T>
cudaError_t launch(const T* x, const T* dy, float* partial, T* out, int blocks,
                   int n, int d, int h, int w, cudaStream_t s) {
  if (blocks > 0) {
    stem_wgrad_partial<T><<<blocks, kThreads, 0, s>>>(x, dy, partial, n, d, h, w);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int grid = (kWeights + kReduceThreads - 1) / kReduceThreads;
  stem_wgrad_reduce<T><<<grid, kReduceThreads, 0, s>>>(partial, blocks, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The stem's weight gradient on `stream`: out (16, 1, 7, 7, 7) = the sum
// over n and q of x[n, 0, q] dy[n, :, q - k + 3].  x (n, 1, d, h, w) and dy
// (n, 16, d, h, w) are contiguous device buffers of one type, float32
// (elem_bytes 4) or bfloat16 (2); out has their type.  partial is a float32
// scratch buffer of blocks x 5,488 values; blocks is the persistent grid,
// from 1 to the number of 8^3 bricks (0 only when there is no brick), and
// fixes the order of the sums.  Returns the cudaError_t of the two
// launches.
int dp_stem_wgrad(const void* x, const void* dy, void* partial, void* out,
                  int elem_bytes, int blocks, int n, int d, int h, int w,
                  void* stream) {
  if (n < 0 || d < 0 || h < 0 || w < 0 || blocks < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t bricks = static_cast<int64_t>(n) * ((d + kBrick - 1) / kBrick) *
                         ((h + kBrick - 1) / kBrick) * ((w + kBrick - 1) / kBrick);
  if (blocks > bricks || (blocks == 0 && bricks > 0) ||
      static_cast<int64_t>(d) * h * w > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* p = static_cast<float*>(partial);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (elem_bytes) {
    case 4:
      err = launch(static_cast<const float*>(x), static_cast<const float*>(dy), p,
                   static_cast<float*>(out), blocks, n, d, h, w, s);
      break;
    case 2:
      err = launch(static_cast<const __nv_bfloat16*>(x),
                   static_cast<const __nv_bfloat16*>(dy), p,
                   static_cast<__nv_bfloat16*>(out), blocks, n, d, h, w, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* dp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
