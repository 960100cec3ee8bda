// Native host kernel for the data-path hot loop: per-stream linear temporal
// resample (torch F.interpolate(mode='linear', align_corners=False) parity,
// reference libs/datasets/deepfake_video_audio.py:996-1018) fused with the
// channel concat into the (out_len, total_C) feature block.
//
// The reference rides torch's C++ DataLoader core for this; our Python loader
// calls this through ctypes (the call releases the GIL, so loader worker
// threads scale across host cores). Coordinate math is float32, matching
// ops/resample.py::_linear_coords bit-for-bit.

#include <algorithm>
#include <cmath>
#include <cstdint>
#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// streams: n pointers to row-major (rows[s], chans[s]) float arrays.
// out: row-major (out_len, sum(chans)) float array.
// n_threads: OpenMP team size; <= 0 uses the library default. Callers inside
// a thread pool (the loader workers) pass 1 — a full team per calling thread
// oversubscribes the host and slows the very loop this kernel accelerates.
int resample_concat(const float** streams, const int* rows, const int* chans,
                    int n_streams, int out_len, float* out, int n_threads) {
  int total_c = 0;
  for (int s = 0; s < n_streams; ++s) {
    if (rows[s] <= 0 || chans[s] <= 0) return -1;
    total_c += chans[s];
  }
#ifdef _OPENMP
  const int nt = n_threads > 0 ? n_threads : omp_get_max_threads();
#else
  (void)n_threads;
  const int nt = 1;
#endif

#pragma omp parallel for schedule(static) num_threads(nt)
  for (int j = 0; j < out_len; ++j) {
    float* out_row = out + (int64_t)j * total_c;
    int c_off = 0;
    for (int s = 0; s < n_streams; ++s) {
      const int in_len = rows[s];
      const int c = chans[s];
      const float* src = streams[s];
      float* dst = out_row + c_off;
      if (in_len == out_len) {
        const float* r = src + (int64_t)j * c;
        for (int k = 0; k < c; ++k) dst[k] = r[k];
      } else {
        const float scale = (float)in_len / (float)out_len;
        float coord = ((float)j + 0.5f) * scale - 0.5f;
        coord = std::min(std::max(coord, 0.0f), (float)(in_len - 1));
        const int i0 = (int)std::floor(coord);
        const int i1 = std::min(i0 + 1, in_len - 1);
        const float frac = coord - (float)i0;
        const float w0 = 1.0f - frac;
        const float* r0 = src + (int64_t)i0 * c;
        const float* r1 = src + (int64_t)i1 * c;
        for (int k = 0; k < c; ++k) dst[k] = r0[k] * w0 + r1[k] * frac;
      }
      c_off += c;
    }
  }
  return 0;
}

}  // extern "C"
