// Per-sample affine patch warp (K4) and the fused augmentation epilogue (K5).
//
// Replaces the TPU kernels deepprior_tpu/ops/pallas_warp.py::
// pallas_warp_patch (_sep_warp_kernel / _warp_kernel, K4) and
// pallas_warp_norm (K5).  The Pallas kernels select source pixels with
// one-hot bf16x3 matmuls in row chunks, and split separable from general
// transforms, because the TPU has no vector gather.  On Hopper a gather from
// shared memory is one load, exact by construction, so both kernels are the
// same loop: one block per sample stages the sample's patch in shared memory
// (64 KB at 128x128, so above the 48 KB default), then every thread gathers
// its output pixels from it.  A separable sample needs no branch: with
// i01 = i10 = 0 the general map adds exact zeros.
//
// K5 (kFusedNorm) unnormalizes each source pixel as it is staged
// (img * s_in + t_in), takes the per-sample maximum of the unnormalized
// source (premax) as a block reduction during the same pass, and after the
// gather applies the recrop z-threshold (com/sc samples only), premax -> zend,
// 0 -> zend, the clip to [zstart, zend] and the renormalization
// (val - t_out) / s_out: nettrainer.py:948-997 in one read and one write of
// the patch batch.
//
// What bounds it: the patch batch is read once and written once (128 KB per
// 128x128 sample); the gather from shared memory and a few dozen flops per
// pixel are cheap next to that.  At a few hundred samples it is one wave of
// blocks, so latency of the staging load, not bandwidth, sets its time.
//
// Exactness: the source coordinate is ((i00*u) + (i01*v)) + i02 and the
// epilogue follows the plain version (ops/hopper_warp.py) op for op, with the
// _rn intrinsics so that nvcc contracts no multiply-add into an FMA.  Like the
// Pallas kernel, and unlike the gather warp ops/crop.py::warp_patch, it does
// not divide by the projective sz (an affine transform has sz = 1 up to an
// ulp).  The output equals the plain version bit for bit.  Build without
// --use_fast_math and without -prec-div=false.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libwarp.so warp.cu   (ops/_build.py does this)

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

// one row of the (B, n) float32 params tensor per sample; the order is fixed
// by deepprior_tpu_torch/ops/hopper_warp.py (PATCH_PARAMS, NORM_PARAMS)
enum Param {
  kI00, kI01, kI02, kI10, kI11, kI12, kNumPatchParams,
  kSIn = kNumPatchParams, kTIn, kThresh, kZsT, kZeT, kZStart2, kZEnd2,
  kTOut, kSOut, kNumNormParams
};

// NaN-propagating max, as torch.amax / jnp.max reduce
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

template <bool kFusedNorm>
__global__ void __launch_bounds__(kThreads)
warp_kernel(const float* __restrict__ src, const float* __restrict__ params,
            float* __restrict__ out, int h, int w, float border, int use_nv,
            float nv_val, float nv_thresh) {
  extern __shared__ float tile[];  // the sample's (h, w) source patch
  __shared__ float warp_max[kWarps];
  const int b = blockIdx.x;
  const int n = h * w;
  const float* prm =
      params + static_cast<int64_t>(b) * (kFusedNorm ? kNumNormParams
                                                     : kNumPatchParams);
  const float* img = src + static_cast<int64_t>(b) * n;

  // stage the source patch (unnormalized for K5) and take its maximum
  float premax = -CUDART_INF_F;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    float val = __ldg(img + i);
    if (kFusedNorm) {
      val = __fadd_rn(__fmul_rn(val, prm[kSIn]), prm[kTIn]);
      premax = nan_max(premax, val);
    }
    tile[i] = val;
  }
  if (kFusedNorm) {
    for (int off = 16; off > 0; off >>= 1)
      premax = nan_max(premax, __shfl_xor_sync(0xffffffffu, premax, off));
    if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = premax;
  }
  __syncthreads();
  if (kFusedNorm) {
    premax = warp_max[0];
    for (int i = 1; i < kWarps; ++i) premax = nan_max(premax, warp_max[i]);
  }

  const float i00 = prm[kI00], i01 = prm[kI01], i02 = prm[kI02];
  const float i10 = prm[kI10], i11 = prm[kI11], i12 = prm[kI12];
  float* dst = out + static_cast<int64_t>(b) * n;
  for (int pix = threadIdx.x; pix < n; pix += kThreads) {
    const int iv = pix / w;
    const float u = static_cast<float>(pix - iv * w);
    const float v = static_cast<float>(iv);
    // inverse map to the source; nearest = floor(x + 0.5), cv2's rounding
    const float x = __fadd_rn(__fadd_rn(__fmul_rn(i00, u), __fmul_rn(i01, v)), i02);
    const float y = __fadd_rn(__fadd_rn(__fmul_rn(i10, u), __fmul_rn(i11, v)), i12);
    const float p = floorf(__fadd_rn(x, 0.5f));
    const float q = floorf(__fadd_rn(y, 0.5f));
    float val = border;
    if (p >= 0.0f && p < static_cast<float>(w) &&
        q >= 0.0f && q < static_cast<float>(h)) {
      val = tile[static_cast<int>(q) * w + static_cast<int>(p)];
    }
    // NYU's invalid-depth marker -> border
    if (use_nv && fabsf(__fsub_rn(val, nv_val)) <= nv_thresh) val = border;
    if (kFusedNorm) {
      // recrop z-threshold, com/sc samples only (augment.py order)
      if (prm[kThresh] > 0.0f) {
        const float zs = prm[kZsT];
        if (val < zs && val != 0.0f) val = zs;
        if (val > prm[kZeT]) val = 0.0f;
      }
      // premax/zero -> far face, clip, renormalize (nettrainer.py:985-997)
      const float lo = prm[kZStart2], hi = prm[kZEnd2];
      if (val == premax) val = hi;
      if (val == 0.0f) val = hi;
      if (val < lo) val = lo;
      if (val > hi) val = hi;
      val = __fdiv_rn(__fsub_rn(val, prm[kTOut]), prm[kSOut]);
    }
    dst[pix] = val;
  }
}

constexpr int kMaxDevices = 64;

// The tile lives in dynamic shared memory.  Dynamic plus static (warp_max)
// shared memory above 48 KB needs the kernel to opt in, per device, so the
// kernel always opts in to the dynamic size it launches with: then only the
// device's per-block maximum bounds the total.  The attribute is set once per
// device and template instance, and again only for a larger patch; a refused
// size fails here, not at launch.
template <bool kFusedNorm>
cudaError_t opt_in_smem(size_t smem) {
  // static storage: zero before the first call; two threads racing here at
  // worst both set the attribute
  static std::atomic<size_t> granted[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && granted[dev].load() >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(warp_kernel<kFusedNorm>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess && dev < kMaxDevices) granted[dev].store(smem);
  return err;
}

template <bool kFusedNorm>
int launch(const float* src, const float* params, float* out, int b, int h,
           int w, float border, int use_nv, float nv_val, float nv_thresh,
           void* stream) {
  if (b == 0 || h * w == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = static_cast<size_t>(h) * w * sizeof(float);
  const cudaError_t err = opt_in_smem<kFusedNorm>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  warp_kernel<kFusedNorm><<<b, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      src, params, out, h, w, border, use_nv, nv_val, nv_thresh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K4: patch (b, h, w) -> out (b, h, w) through params (b, kNumPatchParams),
// the inverse transforms' top two rows.  Launches on `stream` and returns
// the cudaError_t of the launch.  All buffers are contiguous float32 device
// memory; h * w * 4 bytes must fit in one block's shared memory.
int dp_warp_patch(const float* patch, const float* params, float* out, int b,
                  int h, int w, float border, int use_nv, float nv_val,
                  float nv_thresh, void* stream) {
  return launch<false>(patch, params, out, b, h, w, border, use_nv, nv_val,
                       nv_thresh, stream);
}

// K5: normalized patch (b, h, w) -> augmented normalized patch, params
// (b, kNumNormParams).  Same contract as dp_warp_patch.
int dp_warp_norm(const float* patch, const float* params, float* out, int b,
                 int h, int w, float border, int use_nv, float nv_val,
                 float nv_thresh, void* stream) {
  return launch<true>(patch, params, out, b, h, w, border, use_nv, nv_val,
                      nv_thresh, stream);
}

int dp_warp_num_params(int fused) {
  return fused ? kNumNormParams : kNumPatchParams;
}

const char* dp_warp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
