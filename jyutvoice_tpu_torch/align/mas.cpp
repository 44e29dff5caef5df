// Monotonic Alignment Search — native host kernel.
//
// TPU-native equivalent of the reference's Cython extension
// (jyutvoice/utils/monotonic_align/core.pyx): Viterbi max-path DP over the
// (t_x, t_y) log-prior, OpenMP-parallel over the batch. Called from Python
// through ctypes (see jyutvoice_tpu/align/__init__.py); used at training
// time only, on host, mirroring the reference's device->host round trip
// (monotonic_align/__init__.py:7-22).
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC mas.cpp -o libmas.so

#include <algorithm>
#include <cstdint>

namespace {

constexpr float kMaxNegVal = -1e9f;

// Forward DP + backtrack for one batch element.
// value: (t_x, stride_y) row-major, modified in place.
// path:  (t_x, stride_y) int32, zero-initialized by the caller.
void maximum_path_each(int32_t* path, float* value, int t_x, int t_y,
                       int64_t stride_y) {
  for (int y = 0; y < t_y; ++y) {
    int x_lo = std::max(0, t_x + y - t_y);
    int x_hi = std::min(t_x, y + 1);
    for (int x = x_lo; x < x_hi; ++x) {
      float v_cur = (x == y) ? kMaxNegVal : value[x * stride_y + (y - 1)];
      float v_prev;
      if (x == 0) {
        v_prev = (y == 0) ? 0.0f : kMaxNegVal;
      } else {
        v_prev = value[(x - 1) * stride_y + (y - 1)];
      }
      value[x * stride_y + y] += std::max(v_cur, v_prev);
    }
  }
  int index = t_x - 1;
  for (int y = t_y - 1; y >= 0; --y) {
    path[index * stride_y + y] = 1;
    if (index != 0 &&
        (index == y || value[index * stride_y + (y - 1)] <
                           value[(index - 1) * stride_y + (y - 1)])) {
      --index;
    }
  }
}

}  // namespace

extern "C" {

// paths:  (b, t_x, t_y) int32, zeroed by caller.
// values: (b, t_x, t_y) float32, log-prior masked outside the valid region.
// t_xs, t_ys: per-batch valid lengths.
void maximum_path_batch(int32_t* paths, float* values, const int32_t* t_xs,
                        const int32_t* t_ys, int b, int t_x, int t_y) {
#pragma omp parallel for schedule(dynamic)
  for (int i = 0; i < b; ++i) {
    maximum_path_each(paths + (int64_t)i * t_x * t_y,
                      values + (int64_t)i * t_x * t_y, t_xs[i], t_ys[i],
                      t_y);
  }
}

}  // extern "C"
