// Native Canny edge detector for the glyph-conditioning frontend.
//
// The CPU frontend (glyph render -> canny -> masks) sits on the host side of
// every generation request; at serving QPS the numpy implementation
// (reptext/conditioning/canny.py) becomes measurable host overhead. This
// is the same algorithm in tight C++: 3x3 Sobel (per-channel max-L1 for
// multi-channel input, OpenCV semantics), 4-sector non-maximum suppression,
// double threshold + 8-connected hysteresis via an explicit stack.
//
// Reference conditioning semantics: cv2.Canny(img, 50, 100) then inverted
// (RepText/infer.py:16-22). Built with: g++ -O3 -shared -fPIC.
//
// Exposed C ABI (ctypes):
//   void canny_u8(const uint8_t* img, int h, int w, int c,
//                 float low, float high, uint8_t* out);

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr float kTan22 = 0.4142135623730951f;   // tan(22.5 deg)
constexpr float kTan67 = 2.414213562373095f;    // tan(67.5 deg)

inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

}  // namespace

extern "C" {

void canny_u8(const uint8_t* img, int h, int w, int c,
              float low, float high, uint8_t* out) {
  const int n = h * w;
  std::vector<float> mag(n, 0.0f);
  std::vector<float> gx_v(n, 0.0f);
  std::vector<float> gy_v(n, 0.0f);

  // Sobel with nearest-edge padding; multi-channel: keep the channel with the
  // largest |gx|+|gy| per pixel.
  for (int y = 0; y < h; ++y) {
    const int ym = clampi(y - 1, 0, h - 1), yp = clampi(y + 1, 0, h - 1);
    for (int x = 0; x < w; ++x) {
      const int xm = clampi(x - 1, 0, w - 1), xp = clampi(x + 1, 0, w - 1);
      float best = -1.0f, best_gx = 0.0f, best_gy = 0.0f;
      for (int ch = 0; ch < c; ++ch) {
        auto px = [&](int yy, int xx) -> float {
          return static_cast<float>(img[(yy * w + xx) * c + ch]);
        };
        const float tl = px(ym, xm), tc = px(ym, x), tr = px(ym, xp);
        const float ml = px(y, xm),                 mr = px(y, xp);
        const float bl = px(yp, xm), bc = px(yp, x), br = px(yp, xp);
        const float gx = (tr + 2.0f * mr + br) - (tl + 2.0f * ml + bl);
        const float gy = (bl + 2.0f * bc + br) - (tl + 2.0f * tc + tr);
        const float m = std::fabs(gx) + std::fabs(gy);
        if (m > best) { best = m; best_gx = gx; best_gy = gy; }
      }
      const int i = y * w + x;
      mag[i] = best;
      gx_v[i] = best_gx;
      gy_v[i] = best_gy;
    }
  }

  // Non-maximum suppression with 4-sector quantization.
  std::vector<float> nms(n, 0.0f);
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      const int i = y * w + x;
      const float m = mag[i];
      if (m <= 0.0f) continue;
      const float ax = std::fabs(gx_v[i]), ay = std::fabs(gy_v[i]);
      int dy0, dx0, dy1, dx1;
      if (ay > kTan67 * ax) {               // vertical gradient -> horizontal edge
        dy0 = -1; dx0 = 0; dy1 = 1; dx1 = 0;
      } else if (ay > kTan22 * ax) {        // diagonal
        if (gx_v[i] * gy_v[i] < 0.0f) { dy0 = -1; dx0 = 1; dy1 = 1; dx1 = -1; }
        else                          { dy0 = -1; dx0 = -1; dy1 = 1; dx1 = 1; }
      } else {                              // horizontal gradient -> vertical edge
        dy0 = 0; dx0 = -1; dy1 = 0; dx1 = 1;
      }
      auto at = [&](int yy, int xx) -> float {
        if (yy < 0 || yy >= h || xx < 0 || xx >= w) return 0.0f;
        return mag[yy * w + xx];
      };
      const float n0 = at(y + dy0, x + dx0), n1 = at(y + dy1, x + dx1);
      if (m >= n0 && m >= n1) nms[i] = m;
    }
  }

  // Double threshold + 8-connected hysteresis (stack-based flood fill from
  // strong pixels across weak ones).
  std::memset(out, 0, static_cast<size_t>(n));
  std::vector<int> stack;
  stack.reserve(1024);
  for (int i = 0; i < n; ++i) {
    if (nms[i] > high && out[i] == 0) {
      out[i] = 255;
      stack.push_back(i);
      while (!stack.empty()) {
        const int j = stack.back();
        stack.pop_back();
        const int yj = j / w, xj = j % w;
        for (int dy = -1; dy <= 1; ++dy) {
          for (int dx = -1; dx <= 1; ++dx) {
            if (dy == 0 && dx == 0) continue;
            const int yy = yj + dy, xx = xj + dx;
            if (yy < 0 || yy >= h || xx < 0 || xx >= w) continue;
            const int k = yy * w + xx;
            if (out[k] == 0 && nms[k] > low) {
              out[k] = 255;
              stack.push_back(k);
            }
          }
        }
      }
    }
  }
}

}  // extern "C"
