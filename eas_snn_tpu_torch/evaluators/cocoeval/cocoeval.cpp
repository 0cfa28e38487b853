// Fast COCO-protocol detection matching: the C core of the mAP engine
// (the port's copy of eas_snn_tpu/evaluators/cocoeval/cocoeval.cpp).
//
// A plain C ABI driven through ctypes (reference: yolox/layers/cocoeval/
// cocoeval.{h,cpp}, EvaluateImages' greedy IoU matching) over a flat array
// layout: one call evaluates every image of one category for all IoU
// thresholds; precision/recall accumulation stays in vectorized numpy
// (coco_map.py), where it is not a bottleneck.
//
// Matching semantics follow the COCO evaluation protocol exactly:
//  * detections sorted by descending score, truncated to max_det;
//  * ground truths sorted ignored-last;
//  * greedy: each det takes the best unmatched gt with IoU >= threshold;
//    once a non-ignored match exists it is only displaced by a strictly
//    better IoU on another unmatched gt; ignored gts can always absorb;
//  * crowd/ignored gts use IoU-over-det-area (iscrowd semantics);
//  * unmatched dets outside [area_min, area_max) are ignored, as are dets
//    matched to ignored gts.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Box {
  double x, y, w, h;
};

inline double box_iou(const Box& d, const Box& g, bool crowd) {
  const double dx1 = d.x, dy1 = d.y, dx2 = d.x + d.w, dy2 = d.y + d.h;
  const double gx1 = g.x, gy1 = g.y, gx2 = g.x + g.w, gy2 = g.y + g.h;
  const double iw = std::min(dx2, gx2) - std::max(dx1, gx1);
  if (iw <= 0) return 0.0;
  const double ih = std::min(dy2, gy2) - std::max(dy1, gy1);
  if (ih <= 0) return 0.0;
  const double inter = iw * ih;
  const double da = d.w * d.h, ga = g.w * g.h;
  const double uni = crowd ? da : da + ga - inter;
  return uni > 0 ? inter / uni : 0.0;
}

}  // namespace

extern "C" {

// Evaluate all images of one category.
//
//   n_img            number of images
//   gt_off           (n_img+1,) int64 offsets into gt arrays
//   gt_boxes         (G*4,) float64 xywh
//   gt_ignore        (G,) uint8: 1 = ignore (crowd or out of area range)
//   det_off          (n_img+1,) int64 offsets into det arrays
//   det_boxes        (D*4,) float64 xywh
//   det_scores       (D,) float64
//   iou_thrs         (T,) float64
//   n_thr            T
//   area_min/max     det area range for the unmatched-det ignore rule
//   max_det          per-image detection cap (after score sort)
// Outputs (caller-allocated):
//   det_matched      (T*D,) uint8 — det matched a non-ignored gt
//   det_ignored      (T*D,) uint8 — det ignored at this threshold
//   det_rank         (D,) int32 — per-image score rank (>= max_det -> drop)
//
// Returns the number of non-ignored gts of the category (denominator of
// recall).
int64_t coco_match_category(
    int64_t n_img,
    const int64_t* gt_off, const double* gt_boxes, const uint8_t* gt_ignore,
    const int64_t* det_off, const double* det_boxes, const double* det_scores,
    const double* iou_thrs, int64_t n_thr,
    double area_min, double area_max, int64_t max_det,
    uint8_t* det_matched, uint8_t* det_ignored, int32_t* det_rank) {
  const int64_t D = det_off[n_img];
  std::memset(det_matched, 0, n_thr * D);
  std::memset(det_ignored, 0, n_thr * D);
  int64_t n_pos = 0;

  std::vector<int64_t> dord, gord;
  std::vector<double> ious;
  std::vector<int64_t> gmatch;

  for (int64_t img = 0; img < n_img; ++img) {
    const int64_t g0 = gt_off[img], g1 = gt_off[img + 1];
    const int64_t d0 = det_off[img], d1 = det_off[img + 1];
    const int64_t G = g1 - g0;
    int64_t Dn = d1 - d0;

    // dets by descending score (stable for ties)
    dord.resize(Dn);
    for (int64_t i = 0; i < Dn; ++i) dord[i] = d0 + i;
    std::stable_sort(dord.begin(), dord.end(), [&](int64_t a, int64_t b) {
      return det_scores[a] > det_scores[b];
    });
    for (int64_t r = 0; r < Dn; ++r) det_rank[dord[r]] = (int32_t)r;
    if (Dn > max_det) Dn = max_det;

    // gts ignored-last (stable)
    gord.resize(G);
    for (int64_t i = 0; i < G; ++i) gord[i] = g0 + i;
    std::stable_sort(gord.begin(), gord.end(), [&](int64_t a, int64_t b) {
      return gt_ignore[a] < gt_ignore[b];
    });
    for (int64_t i = 0; i < G; ++i)
      if (!gt_ignore[g0 + i]) ++n_pos;

    // pairwise IoUs (det-major)
    ious.assign((size_t)(Dn * G), 0.0);
    for (int64_t di = 0; di < Dn; ++di) {
      const double* db = det_boxes + dord[di] * 4;
      const Box d{db[0], db[1], db[2], db[3]};
      for (int64_t gi = 0; gi < G; ++gi) {
        const int64_t g = gord[gi];
        const double* gb = gt_boxes + g * 4;
        const Box gbox{gb[0], gb[1], gb[2], gb[3]};
        ious[di * G + gi] = box_iou(d, gbox, gt_ignore[g] != 0);
      }
    }

    for (int64_t t = 0; t < n_thr; ++t) {
      const double thr = iou_thrs[t];
      gmatch.assign(G, -1);
      for (int64_t di = 0; di < Dn; ++di) {
        double best = thr < 1e-10 ? 1e-10 : thr;
        int64_t m = -1;
        for (int64_t gi = 0; gi < G; ++gi) {
          if (gmatch[gi] >= 0 && !gt_ignore[gord[gi]]) continue;
          // non-ignored match found and this gt is ignored: stop searching
          // (gts are sorted ignored-last)
          if (m >= 0 && !gt_ignore[gord[m]] && gt_ignore[gord[gi]]) break;
          const double iou = ious[di * G + gi];
          if (iou < best) continue;
          best = iou;
          m = gi;
        }
        const int64_t det = dord[di];
        if (m >= 0) {
          gmatch[m] = det;
          if (gt_ignore[gord[m]]) {
            det_ignored[t * D + det] = 1;
          } else {
            det_matched[t * D + det] = 1;
          }
        } else {
          // unmatched det outside the area range is ignored
          const double* db = det_boxes + det * 4;
          const double area = db[2] * db[3];
          if (area < area_min || area >= area_max)
            det_ignored[t * D + det] = 1;
        }
      }
    }
  }
  return n_pos;
}

}  // extern "C"
