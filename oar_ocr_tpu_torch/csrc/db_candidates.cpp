// Native DB-postprocess candidate extraction: the port's copy.
//
// Copied from native/db_candidates.cpp (lines 1-437, the two entry points
// the port calls: db_candidates and finalize_quads) into a CPython
// extension module of its own, oar_torch_native, whose method table holds
// only those two. The port's loader (oar_ocr_tpu_torch/native.py) builds
// it into oar_ocr_tpu_torch/csrc/build/.
//
// C++ counterpart of the host half of the reference's DB postprocess
// (oar-ocr-core/src/processors/db_bitmap.rs — there native Rust; here a
// CPython extension). One pass over the BIT-PACKED bitmap the device
// ships (oar_ocr_tpu_torch/ops/det_device.pack_bits):
//   unpack → connected components (8-connectivity, iterative flood fill)
//   → boundary pixels → convex hull (monotone chain) → min-area
//   rectangle (rotating calipers) → candidate quads + short sides.
// Replaces np.unpackbits (8× temporary) + cv2.findContours + per-contour
// Python with a single native call.
//
// Exposed as: db_candidates(packed: bytes, height, width, row_stride,
//                           min_size, max_candidates)
//   -> list[(8 floats: x1,y1,x2,y2,x3,y3,x4,y4, min_side)]

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Pt {
  float x, y;
};

static double cross(const Pt& o, const Pt& a, const Pt& b) {
  return (double)(a.x - o.x) * (b.y - o.y) -
         (double)(a.y - o.y) * (b.x - o.x);
}

// Andrew monotone chain; returns hull in counter-clockwise order.
static std::vector<Pt> convex_hull(std::vector<Pt> pts) {
  std::sort(pts.begin(), pts.end(), [](const Pt& a, const Pt& b) {
    return a.x < b.x || (a.x == b.x && a.y < b.y);
  });
  pts.erase(std::unique(pts.begin(), pts.end(),
                        [](const Pt& a, const Pt& b) {
                          return a.x == b.x && a.y == b.y;
                        }),
            pts.end());
  const size_t n = pts.size();
  if (n < 3) return pts;
  std::vector<Pt> hull(2 * n);
  size_t k = 0;
  for (size_t i = 0; i < n; ++i) {
    while (k >= 2 && cross(hull[k - 2], hull[k - 1], pts[i]) <= 0) --k;
    hull[k++] = pts[i];
  }
  const size_t lower = k + 1;
  for (size_t i = n - 1; i-- > 0;) {
    while (k >= lower && cross(hull[k - 2], hull[k - 1], pts[i]) <= 0) --k;
    hull[k++] = pts[i];
  }
  hull.resize(k - 1);
  return hull;
}

// Rotating calipers min-area rect over a convex hull.
// Writes 4 corners + returns min side; corners unordered (Python applies
// the PaddleX ordering).
static float min_area_rect(const std::vector<Pt>& hull, float out[8]) {
  const size_t n = hull.size();
  if (n == 1) {
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = hull[0].x;
      out[2 * i + 1] = hull[0].y;
    }
    return 0.f;
  }
  if (n == 2) {
    out[0] = hull[0].x; out[1] = hull[0].y;
    out[2] = hull[1].x; out[3] = hull[1].y;
    out[4] = hull[1].x; out[5] = hull[1].y;
    out[6] = hull[0].x; out[7] = hull[0].y;
    return 0.f;
  }
  double best_area = 1e30;
  float best[8] = {0};
  float best_side = 0.f;
  for (size_t i = 0; i < n; ++i) {
    const Pt& p0 = hull[i];
    const Pt& p1 = hull[(i + 1) % n];
    double ex = p1.x - p0.x, ey = p1.y - p0.y;
    double len = std::sqrt(ex * ex + ey * ey);
    if (len < 1e-9) continue;
    ex /= len; ey /= len;
    // perpendicular
    double px = -ey, py = ex;
    double min_e = 1e30, max_e = -1e30, min_p = 1e30, max_p = -1e30;
    for (const Pt& q : hull) {
      double de = (q.x - p0.x) * ex + (q.y - p0.y) * ey;
      double dp = (q.x - p0.x) * px + (q.y - p0.y) * py;
      min_e = std::min(min_e, de); max_e = std::max(max_e, de);
      min_p = std::min(min_p, dp); max_p = std::max(max_p, dp);
    }
    double w = max_e - min_e, h = max_p - min_p;
    double area = w * h;
    if (area < best_area) {
      best_area = area;
      best_side = (float)std::min(w, h);
      int k = 0;
      const double corners[4][2] = {{min_e, min_p}, {max_e, min_p},
                                    {max_e, max_p}, {min_e, max_p}};
      for (auto& c : corners) {
        best[k++] = (float)(p0.x + c[0] * ex + c[1] * px);
        best[k++] = (float)(p0.y + c[0] * ey + c[1] * py);
      }
    }
  }
  std::memcpy(out, best, sizeof(best));
  return best_side;
}

static PyObject* db_candidates(PyObject*, PyObject* args) {
  Py_buffer buf;
  int height, width, stride, max_candidates;
  float min_size;
  if (!PyArg_ParseTuple(args, "y*iiifi", &buf, &height, &width, &stride,
                        &min_size, &max_candidates)) {
    return nullptr;
  }
  const uint8_t* packed = (const uint8_t*)buf.buf;
  if ((Py_ssize_t)height * stride > buf.len) {
    PyBuffer_Release(&buf);
    PyErr_SetString(PyExc_ValueError, "packed buffer too small");
    return nullptr;
  }

  // unpack into a padded mask (1-px border simplifies neighbor checks)
  const int W = width + 2, H = height + 2;
  std::vector<uint8_t> mask((size_t)W * H, 0);
  for (int y = 0; y < height; ++y) {
    const uint8_t* row = packed + (size_t)y * stride;
    uint8_t* out = &mask[(size_t)(y + 1) * W + 1];
    for (int xb = 0; xb < stride; ++xb) {
      uint8_t b = row[xb];
      if (!b) continue;
      int base = xb * 8;
      for (int k = 0; k < 8; ++k) {
        int x = base + k;
        if (x < width && (b & (0x80 >> k))) out[x] = 1;
      }
    }
  }

  // Matches the fallback's cv2.findContours(RETR_LIST) candidate set:
  // outer component boundaries AND interior hole boundaries, enumerated
  // in raster order of each contour's first-encountered pixel so that
  // max_candidates truncation picks the same candidates native-on/off.
  struct Cand {
    int anchor;
    float quad[8];
    float side;
  };
  std::vector<Cand> cands;
  std::vector<int32_t> stack;
  std::vector<Pt> boundary;
  const int neigh[8] = {-1, 1, -W, W, -W - 1, -W + 1, W - 1, W + 1};

  // Mark the EXTERIOR background (4-connected flood from the padded
  // border, value 3) so enclosed holes remain 0 and can be found later.
  // Scanline span fill: background dominates a typical page, so span
  // runs beat a per-pixel stack by ~an order of magnitude.
  {
    struct Span {
      int y, x0, x1;
    };
    std::vector<Span> spans;
    auto fill_row = [&](int y, int x0, int x1) {
      uint8_t* row = &mask[(size_t)y * W];
      int x = x0;
      while (x <= x1) {
        if (row[x] != 0) {
          ++x;
          continue;
        }
        int s = x;
        while (s > 0 && row[s - 1] == 0) --s;
        int e = x;
        while (e + 1 < W && row[e + 1] == 0) ++e;
        std::memset(row + s, 3, (size_t)(e - s + 1));
        if (y > 0) spans.push_back({y - 1, s, e});
        if (y + 1 < H) spans.push_back({y + 1, s, e});
        x = e + 1;
      }
    };
    fill_row(0, 0, W - 1);
    while (!spans.empty()) {
      Span sp = spans.back();
      spans.pop_back();
      fill_row(sp.y, sp.x0, sp.x1);
    }
  }

  auto emit = [&](int anchor) {
    if (boundary.size() < 2) return;
    std::vector<Pt> hull = convex_hull(boundary);
    if (hull.empty()) return;
    Cand c;
    c.anchor = anchor;
    c.side = min_area_rect(hull, c.quad);
    if (c.side < min_size || c.side <= 0.f) return;
    cands.push_back(c);
  };

  // Pass 1: foreground components (8-connectivity), outer boundaries.
  // memchr row scans skip the (mostly non-1) background fast.
  for (int y = 1; y <= height; ++y) {
    uint8_t* row = &mask[(size_t)y * W];
    int x = 1;
    while (x <= width) {
      const void* hit = std::memchr(row + x, 1, (size_t)(width - x + 1));
      if (!hit) break;
      x = (int)((const uint8_t*)hit - row);
      int idx = y * W + x;
      boundary.clear();
      stack.clear();
      stack.push_back(idx);
      mask[idx] = 2;
      while (!stack.empty()) {
        int cur = stack.back();
        stack.pop_back();
        int cy = cur / W, cx = cur % W;
        bool is_boundary = false;
        for (int d = 0; d < 4; ++d) {  // 4-neighbors decide boundary
          uint8_t m = mask[cur + neigh[d]];
          if (m != 1 && m != 2) is_boundary = true;
        }
        if (is_boundary) {
          boundary.push_back({(float)(cx - 1), (float)(cy - 1)});
        }
        for (int d = 0; d < 8; ++d) {  // 8-connectivity for the component
          int nb = cur + neigh[d];
          if (mask[nb] == 1) {
            mask[nb] = 2;
            stack.push_back(nb);
          }
        }
      }
      emit(idx);
      ++x;
    }
  }

  // Pass 2: enclosed holes (still 0 — 4-connected zero regions not
  // reachable from the border). RETR_LIST emits these as contours too.
  for (int y = 1; y <= height; ++y) {
    uint8_t* row = &mask[(size_t)y * W];
    int x = 1;
    while (x <= width) {
      const void* hit = std::memchr(row + x, 0, (size_t)(width - x + 1));
      if (!hit) break;
      x = (int)((const uint8_t*)hit - row);
      int idx = y * W + x;
      boundary.clear();
      stack.clear();
      stack.push_back(idx);
      mask[idx] = 4;
      while (!stack.empty()) {
        int cur = stack.back();
        stack.pop_back();
        int cy = cur / W, cx = cur % W;
        // cv2 traces hole borders on the FOREGROUND pixels surrounding
        // the hole — collect those (8-neigh ring) for hull/rect parity.
        for (int d = 0; d < 8; ++d) {
          int nb = cur + neigh[d];
          if (mask[nb] == 2) {
            int ny = nb / W, nx = nb % W;
            boundary.push_back({(float)(nx - 1), (float)(ny - 1)});
          }
        }
        const int dx[4] = {-1, 1, 0, 0}, dy[4] = {0, 0, -1, 1};
        for (int d = 0; d < 4; ++d) {
          int nb = (cy + dy[d]) * W + (cx + dx[d]);
          if (mask[nb] == 0) {
            mask[nb] = 4;
            stack.push_back(nb);
          }
        }
      }
      emit(idx);
      ++x;
    }
  }

  std::stable_sort(cands.begin(), cands.end(),
                   [](const Cand& a, const Cand& b) {
                     return a.anchor < b.anchor;
                   });
  if ((int)cands.size() > max_candidates) cands.resize(max_candidates);

  PyObject* result = PyList_New(0);
  for (const Cand& c : cands) {
    PyObject* tup = PyTuple_New(9);
    for (int i = 0; i < 8; ++i) {
      PyTuple_SET_ITEM(tup, i, PyFloat_FromDouble(c.quad[i]));
    }
    PyTuple_SET_ITEM(tup, 8, PyFloat_FromDouble(c.side));
    PyList_Append(result, tup);
    Py_DECREF(tup);
  }
  PyBuffer_Release(&buf);
  return result;
}

// Batched finalize of candidate mini-boxes — the score-independent half
// of DBPostProcess.finalize_quad (processors/db_postprocess.py:261,
// re-expressing db_bitmap.rs:118-151): unclip delta = area·ratio/perim
// (float64, matching unclip_delta), exact rectangle round-join expansion
// (expand_rect), re-min-area-rect (this file's rotating calipers),
// short-side filter, PaddleX point ordering, scale + round-half-even +
// clamp to original coords. Replaces ~300 µs/candidate of per-quad
// Python/cv2 calls with one native pass (~1 µs/quad).
//
// finalize_quads(minis: bytes (N×8 f32), n, unclip_ratio, min_size,
//                width_scale, height_scale, dest_w, dest_h)
//   -> bytes (N×9 f32: 8 ordered coords + valid flag)
static PyObject* finalize_quads(PyObject*, PyObject* args) {
  Py_buffer buf;
  int n, dest_w, dest_h;
  double unclip_ratio, min_size, width_scale, height_scale;
  if (!PyArg_ParseTuple(args, "y*iddddii", &buf, &n, &unclip_ratio,
                        &min_size, &width_scale, &height_scale, &dest_w,
                        &dest_h)) {
    return nullptr;
  }
  if ((Py_ssize_t)n * 8 * 4 > buf.len) {
    PyBuffer_Release(&buf);
    PyErr_SetString(PyExc_ValueError, "minis buffer too small");
    return nullptr;
  }
  const float* in = (const float*)buf.buf;
  PyObject* out_b =
      PyBytes_FromStringAndSize(nullptr, (Py_ssize_t)n * 9 * 4);
  if (!out_b) {
    PyBuffer_Release(&buf);
    return nullptr;
  }
  float* out = (float*)PyBytes_AS_STRING(out_b);
  std::vector<Pt> pts;
  for (int i = 0; i < n; ++i) {
    const float* q = in + (size_t)i * 8;
    float* o = out + (size_t)i * 9;
    std::memset(o, 0, 9 * sizeof(float));
    double x[4], y[4];
    for (int j = 0; j < 4; ++j) {
      x[j] = q[2 * j];
      y[j] = q[2 * j + 1];
    }
    // unclip_delta: area·ratio/perimeter in float64
    double s1 = 0, s2 = 0, perim = 0;
    for (int j = 0; j < 4; ++j) {
      int k2 = (j + 1) & 3;
      s1 += x[j] * y[k2];
      s2 += y[j] * x[k2];
      perim += std::hypot(x[j] - x[k2], y[j] - y[k2]);
    }
    double area = std::fabs(s1 - s2) / 2.0;
    const double eps = 2.220446049250313e-16;  // np.finfo(f64).eps
    if (area <= eps || perim <= eps) continue;
    double delta = area * unclip_ratio / perim;
    if (delta <= 0) continue;
    // expand_rect: push corners outward along both edge directions
    double ux = x[1] - x[0], uy = y[1] - y[0];
    double vx = x[3] - x[0], vy = y[3] - y[0];
    double nu = std::sqrt(ux * ux + uy * uy);
    double nv = std::sqrt(vx * vx + vy * vy);
    if (nu > 0) {
      ux /= nu;
      uy /= nu;
    } else {
      ux = 1;
      uy = 0;
    }
    if (nv > 0) {
      vx /= nv;
      vy /= nv;
    } else {
      vx = 0;
      vy = 1;
    }
    const double sgnu[4] = {-1, 1, 1, -1}, sgnv[4] = {-1, -1, 1, 1};
    pts.clear();
    for (int j = 0; j < 4; ++j) {
      pts.push_back({(float)(x[j] + delta * (sgnu[j] * ux + sgnv[j] * vx)),
                     (float)(y[j] + delta * (sgnu[j] * uy + sgnv[j] * vy))});
    }
    std::vector<Pt> hull = convex_hull(pts);
    if (hull.empty()) continue;
    float rect[8];
    float side = min_area_rect(hull, rect);
    if (!std::isfinite(side) || side <= 0.f ||
        (double)side < min_size + 2.0) {
      continue;
    }
    // order_mini_box_points: stable x-sort, y-tiebreak within pairs
    Pt p[4] = {{rect[0], rect[1]},
               {rect[2], rect[3]},
               {rect[4], rect[5]},
               {rect[6], rect[7]}};
    std::stable_sort(p, p + 4,
                     [](const Pt& a, const Pt& b) { return a.x < b.x; });
    int i1, i2, i3, i4;
    if (p[1].y > p[0].y) {
      i1 = 0;
      i4 = 1;
    } else {
      i1 = 1;
      i4 = 0;
    }
    if (p[3].y > p[2].y) {
      i2 = 2;
      i3 = 3;
    } else {
      i2 = 3;
      i3 = 2;
    }
    const Pt ord[4] = {p[i1], p[i2], p[i3], p[i4]};
    // scale in f32 (matches np f32·scalar), round half-even, clamp to
    // dest size (db_bitmap.rs:67-75 — not size-1)
    for (int j = 0; j < 4; ++j) {
      float rx = nearbyintf(ord[j].x * (float)width_scale);
      float ry = nearbyintf(ord[j].y * (float)height_scale);
      o[2 * j] = std::min(std::max(rx, 0.f), (float)dest_w);
      o[2 * j + 1] = std::min(std::max(ry, 0.f), (float)dest_h);
    }
    o[8] = 1.f;
  }
  PyBuffer_Release(&buf);
  return out_b;
}

static PyMethodDef Methods[] = {
    {"db_candidates", db_candidates, METH_VARARGS,
     "packed bitmap -> DB candidate quads"},
    {"finalize_quads", finalize_quads, METH_VARARGS,
     "batched unclip+minrect+order+scale of candidate mini-boxes"},
    {nullptr, nullptr, 0, nullptr},
};

static struct PyModuleDef Module = {
    PyModuleDef_HEAD_INIT, "oar_torch_native", nullptr, -1, Methods,
};

}  // namespace

PyMODINIT_FUNC PyInit_oar_torch_native(void) {
  return PyModule_Create(&Module);
}
