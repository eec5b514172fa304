// Fused clamp + metric-cube crop + normalize over batched raw depth frames.
//
// Replaces the TPU kernel deepprior_tpu/ops/pallas_crop.py::
// pallas_normalized_crop / _crop_kernel (nearest, fuse_clamp).  The Pallas
// kernel streams a banded VMEM window per sample and selects pixels with
// one-hot bf16x3 matmuls, because the TPU has no vector gather.  On Hopper a
// gather is one load, exact by construction, so this kernel is one thread per
// output pixel: compute the source index, load it, run the epilogue.
//
// What bounds it: latency and scattered loads, not bytes or arithmetic.  A
// sample reads about 16 K pixels (64 KB) scattered over a 1.2 MB NYU frame
// and writes 64 KB; consecutive threads of a row read consecutive or repeated
// source columns, so a warp's loads fall into a few 32-byte sectors.  The
// design keeps the grid wide (one block row of 256 pixels, B samples) so
// enough loads are in flight to hide the latency.
//
// Exactness: the index map and the epilogue follow deepprior_tpu_torch/ops/
// crop.py op for op, in IEEE float32 with the _rn intrinsics so that nvcc
// never contracts a multiply and an add into an FMA or rewrites a division.
// The output is bit-identical to the plain PyTorch version on the same
// params.  Build without --use_fast_math and without -prec-div=false.
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

  const int iv = pix / dw;
  const float u = static_cast<float>(pix - iv * dw);
  const float v = static_cast<float>(iv);

  // nearest source pixel: cv2.INTER_NEAREST's floor(dst * scale) map
  const float p = __fadd_rn(
      xstart, exact_floor_div(__fmul_rn(__fsub_rn(u, off_x), wb), sz_w));
  const float q = __fadd_rn(
      ystart, exact_floor_div(__fmul_rn(__fsub_rn(v, off_y), hb), sz_h));

  float d = 0.0f;  // out-of-frame parts of the bbox pad with 0
  if (p >= 0.0f && p < static_cast<float>(w) &&
      q >= 0.0f && q < static_cast<float>(h)) {
    const int64_t src = (static_cast<int64_t>(b) * h +
                         static_cast<int64_t>(q)) * w +
                        static_cast<int64_t>(p);
    d = __ldg(dpt + src);
    // the per-image clamp, applied to the pixel read instead of the frame
    if (fuse_clamp && !(d >= prm[kMinD] && d <= prm[kMaxD])) d = 0.0f;
  }
  // z-threshold: near -> zstart, far -> 0
  if (d < zstart && d != 0.0f) d = zstart;
  if (d > zend) d = 0.0f;
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

// Launches the crop on `stream`; returns the cudaError_t of the launch.
// dpt (b, h, w), params (b, kNumParams) and out (b, dh, dw) are contiguous
// float32 device buffers.  Requires b <= 65535 (the grid's y extent).
int dp_normalized_crop(const float* dpt, const float* params, float* out,
                       int b, int h, int w, int dh, int dw,
                       int fuse_clamp, int norm_zero_one, void* stream) {
  if (b == 0 || dh * dw == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((dh * dw + kThreads - 1) / kThreads, b);
  normalized_crop_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      dpt, params, out, h, w, dh, dw, fuse_clamp, norm_zero_one);
  return static_cast<int>(cudaGetLastError());
}

int dp_num_params() { return kNumParams; }

const char* dp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
