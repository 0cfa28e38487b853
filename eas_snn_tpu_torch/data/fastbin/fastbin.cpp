// Native event-binning core for the data-loader hot path.
//
// (reference: yolox/data/datasets/gen1.py:330-360 'sum'/'micro_sum'
// aggregation — per-polarity bincount over flattened pixel indices, run in
// dataloader workers for every sample. numpy's np.add.at / bincount path
// is the reference's known CPU bottleneck (its per-stage profile hooks
// exist because of it, gen1.py:84); this single pass over the decoded
// event arrays replaces bincount + copies.)
//
// C ABI, loaded via ctypes. All arrays are C-contiguous.

#include <cstdint>
#include <cstring>

extern "C" {

// out: (2, H*W) float32 zeroed by caller. Events with t in [t0, t1) only if
// use_window, else all n events.
void polarity_histogram(
    const int64_t n,
    const uint16_t* xs, const uint16_t* ys, const uint8_t* ps,
    const int64_t height, const int64_t width,
    float* out) {
  const int64_t hw = height * width;
  for (int64_t i = 0; i < n; ++i) {
    // Out-of-frame coordinates (corrupt/truncated .dat, wrong img_size
    // config) would scatter into the heap; skip them instead. The numpy
    // fallback raises IndexError on the same data.
    if (xs[i] >= width || ys[i] >= height) continue;
    const int64_t idx = (int64_t)ys[i] * width + xs[i];
    out[(ps[i] & 1) * hw + idx] += 1.0f;
  }
}

// micro_sum: out (Tm, 2, H*W) float32 zeroed by caller; bin edges follow
// the reference slice_events semantics — window length tw (already integer
// floored by the caller), windows start at t_first + k*tw, events with
// rel_t in [k*tw, (k+1)*tw) go to bin k; events past Tm*tw are dropped.
void micro_sum(
    const int64_t n,
    const int64_t* ts, const uint16_t* xs, const uint16_t* ys,
    const uint8_t* ps,
    const int64_t t_first, const int64_t tw, const int64_t n_bins,
    const int64_t height, const int64_t width,
    float* out) {
  if (tw <= 0) return;
  const int64_t hw = height * width;
  const int64_t plane = 2 * hw;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t rel = ts[i] - t_first;
    if (rel < 0) continue;
    const int64_t b = rel / tw;
    if (b >= n_bins) continue;
    if (xs[i] >= width || ys[i] >= height) continue;  // see above
    const int64_t idx = (int64_t)ys[i] * width + xs[i];
    out[b * plane + (ps[i] & 1) * hw + idx] += 1.0f;
  }
}

}  // extern "C"
