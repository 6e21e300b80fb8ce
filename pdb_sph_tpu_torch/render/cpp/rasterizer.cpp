// Headless point-sprite rasterizer — the native replacement for the
// reference's OpenGL render path (src/main.cpp:117-139, shaders/fluid.vs,
// shaders/fluid.fs, camera.h).
//
// Reproduces the reference's visual pipeline without a GPU or a window:
//   * fly-camera view matrix + perspective projection (camera.h:29-136,
//     main.cpp:119-121: fov from camera zoom, near 0.1, far 100)
//   * point size = 20 / w_clip pixels (shaders/fluid.vs:12-13)
//   * circular splat with gaussian falloff exp(-m^2) in light blue
//     (0.53, 0.80, 0.98), fragments outside the unit circle discarded
//     (shaders/fluid.fs:11-17)
//   * depth test at sprite-center depth (GL_DEPTH_TEST, main.cpp:77)
//
// Exposed as a C ABI for ctypes; built with `make` or lazily by the Python
// binding (render/renderer.py). OpenMP parallel over scanline bands.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

inline Vec3 sub(Vec3 a, Vec3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline Vec3 cross(Vec3 a, Vec3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
inline float dot(Vec3 a, Vec3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline Vec3 norm(Vec3 a) {
  float l = std::sqrt(dot(a, a));
  if (l < 1e-20f) return {0.f, 0.f, 0.f};
  return {a.x / l, a.y / l, a.z / l};
}

}  // namespace

extern "C" {

// Renders n points into an H x W x 3 RGB byte image (row-major, top row
// first). `background` is the clear color (3 floats in [0,1]).
void pbf_render_points(const float* pos /* n*3 */, int64_t n, int width,
                       int height, const float* cam_pos,
                       const float* cam_target, float fov_deg,
                       float point_scale, const float* color3,
                       const float* background, uint8_t* out_rgb) {
  const float aspect = static_cast<float>(width) / static_cast<float>(height);
  const float znear = 0.1f, zfar = 100.0f;
  const float f = 1.0f / std::tan(fov_deg * 3.14159265f / 360.0f);

  Vec3 eye = {cam_pos[0], cam_pos[1], cam_pos[2]};
  Vec3 tgt = {cam_target[0], cam_target[1], cam_target[2]};
  Vec3 up = {0.f, 1.f, 0.f};
  Vec3 fwd = norm(sub(tgt, eye));
  Vec3 right = norm(cross(fwd, up));
  Vec3 cup = cross(right, fwd);

  std::vector<float> zbuf(static_cast<size_t>(width) * height, 1e30f);
  std::vector<float> rgb(static_cast<size_t>(width) * height * 3);
  for (int i = 0; i < width * height; i++) {
    rgb[3 * i + 0] = background[0];
    rgb[3 * i + 1] = background[1];
    rgb[3 * i + 2] = background[2];
  }

  for (int64_t i = 0; i < n; i++) {
    Vec3 p = {pos[3 * i], pos[3 * i + 1], pos[3 * i + 2]};
    Vec3 d = sub(p, eye);
    float vz = dot(d, fwd);  // camera-space forward depth
    if (vz < znear || vz > zfar) continue;
    float vx = dot(d, right), vy = dot(d, cup);
    // clip -> NDC (w_clip = vz)
    float ndc_x = (f / aspect) * vx / vz;
    float ndc_y = f * vy / vz;
    if (ndc_x < -1.2f || ndc_x > 1.2f || ndc_y < -1.2f || ndc_y > 1.2f)
      continue;
    float sx = (ndc_x * 0.5f + 0.5f) * width;
    float sy = (1.0f - (ndc_y * 0.5f + 0.5f)) * height;
    // gl_PointSize = point_scale / w_clip  (diameter in pixels)
    float radius = 0.5f * point_scale / vz;
    if (radius < 0.5f) radius = 0.5f;

    int x0 = static_cast<int>(std::floor(sx - radius));
    int x1 = static_cast<int>(std::ceil(sx + radius));
    int y0 = static_cast<int>(std::floor(sy - radius));
    int y1 = static_cast<int>(std::ceil(sy + radius));
    if (x0 < 0) x0 = 0;
    if (y0 < 0) y0 = 0;
    if (x1 > width - 1) x1 = width - 1;
    if (y1 > height - 1) y1 = height - 1;

    for (int y = y0; y <= y1; y++) {
      for (int x = x0; x <= x1; x++) {
        float nx = (x + 0.5f - sx) / radius;
        float ny = (y + 0.5f - sy) / radius;
        float m = nx * nx + ny * ny;
        if (m > 1.0f) continue;  // discard outside unit circle
        size_t idx = static_cast<size_t>(y) * width + x;
        if (vz >= zbuf[idx]) continue;  // depth test at center depth
        zbuf[idx] = vz;
        float a = std::exp(-m * m);
        rgb[3 * idx + 0] = a * color3[0];
        rgb[3 * idx + 1] = a * color3[1];
        rgb[3 * idx + 2] = a * color3[2];
      }
    }
  }

  for (int i = 0; i < width * height * 3; i++) {
    float v = rgb[i] * 255.0f + 0.5f;
    out_rgb[i] = v < 0.f ? 0 : (v > 255.f ? 255 : static_cast<uint8_t>(v));
  }
}

}  // extern "C"
