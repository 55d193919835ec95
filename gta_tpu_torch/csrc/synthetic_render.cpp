// Host renderer for the synthetic scenes: pinhole ray generation and
// analytic sphere-scene rendering (C ABI, bound with ctypes by
// gta_tpu_torch/data/native.py). The port's copy of the JAX package's
// csrc/synthetic_render.cpp, the same code.
//
// Semantics mirror gta_tpu_torch/data/synthetic.py::_render and
// gta_tpu_torch/geometry/rays.py::camera_rays_from_extrinsic (float32 math
// against their float64: rays within 1e-4, images equal but for sphere-
// silhouette pixels). Multithreaded over views.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

inline Vec3 operator+(Vec3 a, Vec3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
inline Vec3 operator-(Vec3 a, Vec3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline Vec3 operator*(float s, Vec3 a) { return {s * a.x, s * a.y, s * a.z}; }
inline float dot(Vec3 a, Vec3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline Vec3 normalize(Vec3 a) {
  float n = std::sqrt(dot(a, a));
  return {a.x / n, a.y / n, a.z / n};
}

void render_view(const float* cam_pos, const float* extrinsic,
                 const float* centers, const float* radii, const float* colors,
                 int n_spheres, int h, int w, float focal, float sensor_w,
                 float* out_img, float* out_rays) {
  const Vec3 pos = {cam_pos[0], cam_pos[1], cam_pos[2]};
  const Vec3 right = {extrinsic[0], extrinsic[1], extrinsic[2]};
  const Vec3 up = {extrinsic[4], extrinsic[5], extrinsic[6]};
  const Vec3 front = {extrinsic[8], extrinsic[9], extrinsic[10]};

  const Vec3 plane_center = pos + focal * front;
  const float sensor_h = (sensor_w / w) * h;

  Vec3 light = normalize({0.4f, 0.3f, 0.85f});

  for (int i = 0; i < h; ++i) {
    // pixel-center offsets matching np.linspace boundary midpoints
    float v_off = (-1.0f + (2.0f * i + 1.0f) / h) * sensor_h * 0.5f;
    for (int j = 0; j < w; ++j) {
      float h_off = (-1.0f + (2.0f * j + 1.0f) / w) * sensor_w * 0.5f;
      Vec3 p = plane_center + h_off * right + v_off * up;
      Vec3 ray = normalize(p - pos);
      float* rp = out_rays + (static_cast<int64_t>(i) * w + j) * 3;
      rp[0] = ray.x;
      rp[1] = ray.y;
      rp[2] = ray.z;

      // nearest sphere intersection
      float t_near = INFINITY;
      int k_near = -1;
      for (int s = 0; s < n_spheres; ++s) {
        Vec3 c = {centers[3 * s], centers[3 * s + 1], centers[3 * s + 2]};
        Vec3 oc = pos - c;
        float b = dot(oc, ray);
        float cq = dot(oc, oc) - radii[s] * radii[s];
        float disc = b * b - cq;
        if (disc > 0.0f) {
          float t = -b - std::sqrt(disc);
          if (t > 1e-3f && t < t_near) {
            t_near = t;
            k_near = s;
          }
        }
      }

      float* px = out_img + (static_cast<int64_t>(i) * w + j) * 3;
      if (k_near >= 0) {
        Vec3 c = {centers[3 * k_near], centers[3 * k_near + 1],
                  centers[3 * k_near + 2]};
        Vec3 hit = pos + t_near * ray;
        Vec3 n = normalize(hit - c);
        float shade = dot(n, light);
        shade = 0.35f + 0.65f * (shade > 0.0f ? (shade < 1.0f ? shade : 1.0f) : 0.0f);
        px[0] = colors[3 * k_near] * shade;
        px[1] = colors[3 * k_near + 1] * shade;
        px[2] = colors[3 * k_near + 2] * shade;
      } else {
        // background gradient on ray z (matches numpy renderer)
        float g = 0.5f + 0.4f * ray.z;
        px[0] = 0.5f + 0.4f * ray.z * 0.6f;
        px[1] = 0.5f + 0.4f * ray.z * 0.7f;
        px[2] = 0.5f + 0.4f * ray.z * 1.0f;
        (void)g;
      }
      for (int ch = 0; ch < 3; ++ch) {
        px[ch] = px[ch] < 0.0f ? 0.0f : (px[ch] > 1.0f ? 1.0f : px[ch]);
      }
    }
  }
}

}  // namespace

extern "C" {

// Render nv views: images [nv,h,w,3] and unit rays [nv,h,w,3].
// extrinsics: [nv,4,4] row-major world->camera (rows: right, up, front, hom).
void gta_render_views(const float* cam_pos, const float* extrinsics,
                      const float* centers, const float* radii,
                      const float* colors, int n_spheres, int nv, int h, int w,
                      float focal, float sensor_w, float* out_images,
                      float* out_rays) {
  int n_threads = static_cast<int>(std::thread::hardware_concurrency());
  if (n_threads <= 0) n_threads = 4;
  std::atomic<int> next{0};
  auto worker = [&]() {
    for (;;) {
      int v = next.fetch_add(1);
      if (v >= nv) return;
      render_view(cam_pos + 3 * v, extrinsics + 16 * v, centers, radii, colors,
                  n_spheres, h, w, focal, sensor_w,
                  out_images + static_cast<int64_t>(v) * h * w * 3,
                  out_rays + static_cast<int64_t>(v) * h * w * 3);
    }
  };
  std::vector<std::thread> pool;
  int n = n_threads < nv ? n_threads : nv;
  for (int t = 0; t < n; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

}  // extern "C"
