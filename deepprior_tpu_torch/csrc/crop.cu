// Fused clamp + metric-cube crop + normalize over batched raw depth frames.
//
// Replaces the TPU kernel deepprior_tpu/ops/pallas_crop.py::
// pallas_normalized_crop / _crop_kernel / _sample_crop in both of its
// resize modes: K1, nearest (normalized_crop_kernel<false>), and K2, the
// cv2-linear crop (use_bilinear=True, normalized_crop_kernel<true>).  The
// Pallas kernel streams a banded VMEM window per sample and selects pixels
// with one-hot (K1) or weighted two-tap (K2) matmuls, because the TPU has
// no vector gather.  On Hopper a gather is one load, exact by construction,
// so this kernel is one thread per output pixel: compute the source
// index (K1) or the four taps (K2), load, run the epilogue.
//
// What bounds it: latency and scattered loads, not bytes or arithmetic.  A
// sample reads about 16 K pixels (64 KB) scattered over a 1.2 MB NYU frame
// and writes 64 KB; consecutive threads of a row read consecutive or repeated
// source columns, so a warp's loads fall into a few 32-byte sectors.  The
// design keeps the grid wide (one block row of 256 pixels, B samples) so
// enough loads are in flight to hide the latency.
//
// K2 reads four taps per pixel instead of one, so it moves about four times
// K1's scattered sectors; neighbouring threads share most taps, so the
// extra loads hit L1.  It stays a gather, latency-bound like K1.
//
// Exactness: the index map, the taps, the blend and the epilogue follow
// deepprior_tpu_torch/ops/crop.py::crop3d op for op, in IEEE float32 with
// the _rn intrinsics so that nvcc never contracts a multiply and an add into
// an FMA or rewrites a division.  K2's blend is the plain version's
// left-to-right d00*(1-fy)*(1-fx) + d01*(1-fy)*fx + d10*fy*(1-fx) +
// d11*fy*fx.  The output is bit-identical to the plain PyTorch version on
// the same params.  Build without --use_fast_math and without
// -prec-div=false.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libcrop.so crop.cu   (ops/_build.py does this)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// one row of the (B, kNumParams) float32 params tensor per sample; the order
// is fixed by deepprior_tpu_torch/ops/hopper_crop.py::crop_params
enum Param {
  kXStart, kYStart, kWb, kHb, kOffX, kOffY, kZStart, kZEnd,
  kComZ, kCubeHalf, kSzW, kSzH, kMinD, kMaxD, kNumParams
};

// floor(a / b) for integer-valued a (|a| < 2^23) and b > 0; the same
// correction step as ops/crop.py::_exact_floor_div
__device__ __forceinline__ float exact_floor_div(float a, float b) {
  float q = floorf(__fdiv_rn(a, b));
  const float r = __fsub_rn(a, __fmul_rn(q, b));
  if (r >= b) q = __fadd_rn(q, 1.0f);
  if (r < 0.0f) q = __fsub_rn(q, 1.0f);
  return q;
}

// cv2's half-pixel two-tap geometry along one axis (ops/resize.py::
// halfpixel_taps): source coordinate, taps clamped to the patch [0, extent-1],
// blend fraction clamped to [0, 1]; taps in image coordinates
__device__ __forceinline__ void linear_taps(float o, float off, float extent,
                                            float sz, float start, float* t0,
                                            float* t1, float* frac) {
  const float sp = __fsub_rn(
      __fmul_rn(__fadd_rn(__fsub_rn(o, off), 0.5f), __fdiv_rn(extent, sz)),
      0.5f);
  const float last = __fsub_rn(extent, 1.0f);
  const float a = fminf(fmaxf(floorf(sp), 0.0f), last);
  *frac = fminf(fmaxf(__fsub_rn(sp, a), 0.0f), 1.0f);
  *t1 = __fadd_rn(fminf(__fadd_rn(a, 1.0f), last), start);
  *t0 = __fadd_rn(a, start);
}

// the depth at image pixel (q, p) of sample b: 0 outside the frame and,
// under fuse_clamp, outside the image's [min_d, max_d]
__device__ __forceinline__ float read_depth(const float* __restrict__ img,
                                            float q, float p, int h, int w,
                                            bool clamp, float min_d,
                                            float max_d) {
  if (!(p >= 0.0f && p < static_cast<float>(w) &&
        q >= 0.0f && q < static_cast<float>(h))) {
    return 0.0f;
  }
  const float d = __ldg(img + static_cast<int64_t>(q) * w +
                        static_cast<int64_t>(p));
  return clamp && !(d >= min_d && d <= max_d) ? 0.0f : d;
}

// z-threshold (handdetector.py:291-295): near -> zstart, far -> 0
__device__ __forceinline__ float threshold(float d, float zstart, float zend) {
  if (d < zstart && d != 0.0f) d = zstart;
  return d > zend ? 0.0f : d;
}

template <bool kLinear>
__global__ void __launch_bounds__(kThreads)
normalized_crop_kernel(const float* __restrict__ dpt,
                       const float* __restrict__ params,
                       float* __restrict__ out,
                       int h, int w, int dh, int dw,
                       int fuse_clamp, int norm_zero_one) {
  const int b = blockIdx.y;
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix >= dh * dw) return;
  const float* prm = params + static_cast<int64_t>(b) * kNumParams;
  const float xstart = prm[kXStart], ystart = prm[kYStart];
  const float wb = prm[kWb], hb = prm[kHb];
  const float off_x = prm[kOffX], off_y = prm[kOffY];
  const float zstart = prm[kZStart], zend = prm[kZEnd];
  const float com_z = prm[kComZ], cube_half = prm[kCubeHalf];
  const float sz_w = prm[kSzW], sz_h = prm[kSzH];
  const bool clamp = fuse_clamp != 0;
  const float min_d = prm[kMinD], max_d = prm[kMaxD];
  const float* img = dpt + static_cast<int64_t>(b) * h * w;

  const int iv = pix / dw;
  const float u = static_cast<float>(pix - iv * dw);
  const float v = static_cast<float>(iv);

  float d;
  if (kLinear) {
    float x0, x1, fx, y0, y1, fy;
    linear_taps(u, off_x, wb, sz_w, xstart, &x0, &x1, &fx);
    linear_taps(v, off_y, hb, sz_h, ystart, &y0, &y1, &fy);
    // each tap thresholded before the blend (crop -> threshold -> resize)
    const float d00 = threshold(read_depth(img, y0, x0, h, w, clamp, min_d, max_d), zstart, zend);
    const float d01 = threshold(read_depth(img, y0, x1, h, w, clamp, min_d, max_d), zstart, zend);
    const float d10 = threshold(read_depth(img, y1, x0, h, w, clamp, min_d, max_d), zstart, zend);
    const float d11 = threshold(read_depth(img, y1, x1, h, w, clamp, min_d, max_d), zstart, zend);
    const float gy = __fsub_rn(1.0f, fy), gx = __fsub_rn(1.0f, fx);
    d = __fmul_rn(__fmul_rn(d00, gy), gx);
    d = __fadd_rn(d, __fmul_rn(__fmul_rn(d01, gy), fx));
    d = __fadd_rn(d, __fmul_rn(__fmul_rn(d10, fy), gx));
    d = __fadd_rn(d, __fmul_rn(__fmul_rn(d11, fy), fx));
    // no post-blend threshold: a blend of thresholded taps may lie below
    // zstart legitimately
  } else {
    // nearest source pixel: cv2.INTER_NEAREST's floor(dst * scale) map
    const float p = __fadd_rn(
        xstart, exact_floor_div(__fmul_rn(__fsub_rn(u, off_x), wb), sz_w));
    const float q = __fadd_rn(
        ystart, exact_floor_div(__fmul_rn(__fsub_rn(v, off_y), hb), sz_h));
    // out-of-frame parts of the bbox pad with 0
    d = threshold(read_depth(img, q, p, h, w, clamp, min_d, max_d), zstart, zend);
  }
  // outside the embedded (resized) region: background
  const bool in_embed = u >= off_x && u < __fadd_rn(off_x, sz_w) &&
                        v >= off_y && v < __fadd_rn(off_y, sz_h);
  if (!in_embed) d = 0.0f;
  // normalize; background 0 -> the far cube face
  if (d == 0.0f) d = __fadd_rn(com_z, cube_half);
  float r;
  if (norm_zero_one) {
    r = __fdiv_rn(__fsub_rn(d, __fsub_rn(com_z, cube_half)),
                  __fmul_rn(2.0f, cube_half));
  } else {
    r = __fdiv_rn(__fsub_rn(d, com_z), cube_half);
  }
  out[static_cast<int64_t>(b) * dh * dw + pix] = r;
}

}  // namespace

extern "C" {

// Launches the crop on `stream`: the cv2-linear K2 when `linear`, else the
// nearest K1.  Returns the cudaError_t of the launch.  dpt (b, h, w),
// params (b, kNumParams) and out (b, dh, dw) are contiguous float32 device
// buffers.  Requires b <= 65535 (the grid's y extent).
int dp_normalized_crop(const float* dpt, const float* params, float* out,
                       int b, int h, int w, int dh, int dw,
                       int fuse_clamp, int norm_zero_one, int linear,
                       void* stream) {
  if (b == 0 || dh * dw == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((dh * dw + kThreads - 1) / kThreads, b);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (linear) {
    normalized_crop_kernel<true><<<grid, kThreads, 0, s>>>(
        dpt, params, out, h, w, dh, dw, fuse_clamp, norm_zero_one);
  } else {
    normalized_crop_kernel<false><<<grid, kThreads, 0, s>>>(
        dpt, params, out, h, w, dh, dw, fuse_clamp, norm_zero_one);
  }
  return static_cast<int>(cudaGetLastError());
}

int dp_num_params() { return kNumParams; }

const char* dp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
