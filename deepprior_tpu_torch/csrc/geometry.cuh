// The port's per-sample geometry in device code, shared by the kernels that
// compute it themselves: the crop (crop.cu, K1/K2) and the fused
// augmentation warp (warp.cu, K5).
//
// Each function follows its plain PyTorch counterpart op for op, in IEEE
// float32 with the __f*_rn intrinsics so that nvcc contracts no multiply and
// add into an FMA and rewrites no division; the kernels' outputs are then
// bit-identical to the plain versions.  The rules that fix the rounding:
// PyTorch computes `tensor * python_float` with the float cast to float32,
// `t / 2.0` as an exact halving (a multiply by 0.5), `torch.isclose(d, 0)`
// as |d| <= 1e-8f, and every tensor / tensor division as IEEE division;
// torch.cos / torch.sin on CUDA float32 are the full-precision cosf / sinf.
// Build without --use_fast_math and without -prec-div=false.

#pragma once

#include <cuda_runtime.h>

namespace dp {

// one crop's geometry (ops/crop.py::com_to_bounds and _embed_geometry) and
// the normalization constants the crop kernel adds to it
struct Geometry {
  float xstart, ystart, wb, hb, off_x, off_y, sz_w, sz_h;
  float zstart, zend, com_z, cube_z, cube_half, lo, bg, min_d, max_d;
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

// The geometry of a crop of the (h, w) frame around com (u, v, d) with the
// metric cube (3 floats) onto a (dh, dw) canvas, and its crop transform m
// (row-major 3x3): ops/crop.py::com_to_bounds (:76-110), _embed_geometry
// (:124-139), _transform_matrix (:150-157) and normalize_crop's constants,
// op for op.  fx and fy arrive as float32.
__device__ Geometry sample_geometry(const float* com, const float* cube,
                                    float fx, float fy, int h, int w, int dh,
                                    int dw, float* m) {
  const float u = com[0], v = com[1], d = com[2];
  Geometry g;
  // torch.isclose(d, 0): |d - 0| <= atol + rtol * |0|, atol 1e-8 in float32
  const bool ill = fabsf(d) <= 1e-8f;
  const float safe_d = ill ? 1.0f : d;
  const float ux = __fdiv_rn(__fmul_rn(u, safe_d), fx);
  const float vy = __fdiv_rn(__fmul_rn(v, safe_d), fy);
  const float hx = __fmul_rn(cube[0], 0.5f);  // cube / 2.0: exact halving
  const float hy = __fmul_rn(cube[1], 0.5f);
  g.cube_z = cube[2];
  g.cube_half = __fmul_rn(g.cube_z, 0.5f);
  float xs = floorf(__fadd_rn(
      __fmul_rn(__fdiv_rn(__fsub_rn(ux, hx), safe_d), fx), 0.5f));
  float xe = floorf(__fadd_rn(
      __fmul_rn(__fdiv_rn(__fadd_rn(ux, hx), safe_d), fx), 0.5f));
  float ys = floorf(__fadd_rn(
      __fmul_rn(__fdiv_rn(__fsub_rn(vy, hy), safe_d), fy), 0.5f));
  float ye = floorf(__fadd_rn(
      __fmul_rn(__fdiv_rn(__fadd_rn(vy, hy), safe_d), fy), 0.5f));
  g.zstart = __fsub_rn(d, g.cube_half);
  g.zend = __fadd_rn(d, g.cube_half);
  if (ill) {  // the centred half-frame crop
    xs = static_cast<float>(w / 4);
    xe = static_cast<float>(w / 4 + w / 2);
    ys = static_cast<float>(h / 4);
    ye = static_cast<float>(h / 4 + h / 2);
    g.zstart = 10.0f;
    g.zend = 1500.0f;
  }
  // aspect-preserving resize, centred on the (dw, dh) canvas
  const float fdw = static_cast<float>(dw), fdh = static_cast<float>(dh);
  const float wb = __fsub_rn(xe, xs), hb = __fsub_rn(ye, ys);
  float scale;
  if (wb > hb) {
    scale = __fdiv_rn(fdw, wb);
    g.sz_w = fdw;
    g.sz_h = exact_floor_div(__fmul_rn(hb, fdw), wb);
  } else {
    scale = __fdiv_rn(fdh, hb);
    g.sz_w = exact_floor_div(__fmul_rn(wb, fdh), hb);
    g.sz_h = fdh;
  }
  g.off_x = floorf(__fsub_rn(__fmul_rn(fdw, 0.5f), __fmul_rn(g.sz_w, 0.5f)));
  g.off_y = floorf(__fsub_rn(__fmul_rn(fdh, 0.5f), __fmul_rn(g.sz_h, 0.5f)));
  g.xstart = xs;
  g.ystart = ys;
  g.wb = wb;
  g.hb = hb;
  g.com_z = d;
  g.lo = __fsub_rn(d, g.cube_half);
  m[0] = scale;
  m[1] = 0.0f;
  m[2] = __fadd_rn(__fmul_rn(-scale, xs), g.off_x);
  m[3] = 0.0f;
  m[4] = scale;
  m[5] = __fadd_rn(__fmul_rn(-scale, ys), g.off_y);
  m[6] = 0.0f;
  m[7] = 0.0f;
  m[8] = 1.0f;
  return g;
}

// a pinhole camera (camera.py::Camera), the intrinsics as float32
struct Camera {
  float fx, fy, ux, uy;
  int flip_y;
};

// camera.py::Camera.img_to_3d: (u, v, d) -> metric (x, y, z)
__device__ __forceinline__ void img_to_3d(const Camera& cam, const float* uvd,
                                          float* xyz) {
  const float d = uvd[2];
  xyz[0] = __fdiv_rn(__fmul_rn(__fsub_rn(uvd[0], cam.ux), d), cam.fx);
  const float dv = cam.flip_y ? __fsub_rn(cam.uy, uvd[1])
                              : __fsub_rn(uvd[1], cam.uy);
  xyz[1] = __fdiv_rn(__fmul_rn(dv, d), cam.fy);
  xyz[2] = d;
}

// camera.py::Camera.three_d_to_img: z == 0 maps to the principal point
__device__ __forceinline__ void three_d_to_img(const Camera& cam,
                                               const float* xyz, float* uvd) {
  const float z = xyz[2];
  const bool at_zero = z == 0.0f;
  const float safe_z = at_zero ? 1.0f : z;
  const float u = __fadd_rn(__fmul_rn(__fdiv_rn(xyz[0], safe_z), cam.fx),
                            cam.ux);
  const float t = __fmul_rn(__fdiv_rn(xyz[1], safe_z), cam.fy);
  const float v = cam.flip_y ? __fsub_rn(cam.uy, t) : __fadd_rn(t, cam.uy);
  uvd[0] = at_zero ? cam.ux : u;
  uvd[1] = at_zero ? cam.uy : v;
  uvd[2] = z;
}

// a * b - c * d in the plain version's order: two products, one difference
__device__ __forceinline__ float cross(float a, float b, float c, float d) {
  return __fsub_rn(__fmul_rn(a, b), __fmul_rn(c, d));
}

// geometry.py::inv3x3 (row-major), the adjugate in its op order
__device__ __forceinline__ void inv3x3(const float* m, float* out) {
  const float a = m[0], b = m[1], c = m[2];
  const float d = m[3], e = m[4], f = m[5];
  const float g = m[6], h = m[7], i = m[8];
  const float co_a = cross(e, i, f, h);
  const float co_b = -cross(d, i, f, g);
  const float co_c = cross(d, h, e, g);
  const float det = __fadd_rn(__fadd_rn(__fmul_rn(a, co_a), __fmul_rn(b, co_b)),
                              __fmul_rn(c, co_c));
  const float inv_det = __fdiv_rn(1.0f, det);
  const float adj[9] = {co_a, -cross(b, i, c, h), cross(b, f, c, e),
                        co_b, cross(a, i, c, g),  -cross(a, f, c, d),
                        co_c, -cross(a, h, b, g), cross(a, e, b, d)};
#pragma unroll
  for (int k = 0; k < 9; ++k) out[k] = __fmul_rn(adj[k], inv_det);
}

// geometry.py::matmul3x3: out[i][k] = (a[i][0] b[0][k] + a[i][1] b[1][k])
// + a[i][2] b[2][k]
__device__ __forceinline__ void matmul3x3(const float* a, const float* b,
                                          float* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      out[3 * i + k] = __fadd_rn(
          __fadd_rn(__fmul_rn(a[3 * i], b[k]), __fmul_rn(a[3 * i + 1], b[3 + k])),
          __fmul_rn(a[3 * i + 2], b[6 + k]));
    }
  }
}

// float32(pi / 180), geometry.py's _DEG2RAD
constexpr float kDeg2Rad = 0.017453292519943295f;

// geometry.py::rotation_matrix_2d: rotation by `deg` about (cx, cy)
__device__ __forceinline__ void rotation_matrix_2d(float cx, float cy,
                                                   float deg, float* out) {
  const float a = __fmul_rn(deg, kDeg2Rad);
  const float c = cosf(a), s = sinf(a);
  out[0] = c;
  out[1] = -s;
  out[2] = __fadd_rn(__fsub_rn(cx, __fmul_rn(c, cx)), __fmul_rn(s, cy));
  out[3] = s;
  out[4] = c;
  out[5] = __fsub_rn(__fsub_rn(cy, __fmul_rn(s, cx)), __fmul_rn(c, cy));
  out[6] = 0.0f;
  out[7] = 0.0f;
  out[8] = 1.0f;
}

}  // namespace dp
