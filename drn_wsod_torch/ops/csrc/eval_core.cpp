// Greedy detection-to-GT matching on the host, the sequential inner loop
// of VOC AP, VOC CorLoc and COCO-style AP (evaluation/voc_eval.py binds
// the first two through native.py; coco_match is bound and tested but has
// no caller in the evaluators).
//
// Plain C ABI, loaded with ctypes. All arithmetic is float64 in the order
// of voc_eval.py's numpy twin (_voc_overlaps), so that an IoU lands on the
// same double and a detection exactly at the threshold takes the same side
// of the strict `>` test: ops/_build.py compiles this source with
// -ffp-contract=off, so no multiply-add is fused into one rounding.

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

// The VOC devkit's IoU: pixel-inclusive extents (+1 on each side length).
inline double iou_voc(const double* gt, const double* det) {
  const double iw = std::max(std::min(gt[2], det[2]) -
                                 std::max(gt[0], det[0]) + 1.0,
                             0.0);
  const double ih = std::max(std::min(gt[3], det[3]) -
                                 std::max(gt[1], det[1]) + 1.0,
                             0.0);
  const double inter = iw * ih;
  const double uni = (det[2] - det[0] + 1.0) * (det[3] - det[1] + 1.0) +
                     (gt[2] - gt[0] + 1.0) * (gt[3] - gt[1] + 1.0) - inter;
  return uni > 0.0 ? inter / uni : 0.0;
}

// COCO's IoU: continuous extents, no +1.
inline double iou_coco(const double* gt, const double* det) {
  const double iw =
      std::max(std::min(gt[2], det[2]) - std::max(gt[0], det[0]), 0.0);
  const double ih =
      std::max(std::min(gt[3], det[3]) - std::max(gt[1], det[1]), 0.0);
  const double inter = iw * ih;
  const double uni = (det[2] - det[0]) * (det[3] - det[1]) +
                     (gt[2] - gt[0]) * (gt[3] - gt[1]) - inter;
  return uni > 0.0 ? inter / uni : 0.0;
}

}  // namespace

extern "C" {

// One class of a VOC dataset. The D detections come in descending
// confidence (boxes (D, 4), image index each, -1 or out of range for an
// image the GT does not list); the GT boxes (G, 4) are grouped by image,
// image i's being [gt_offsets[i], gt_offsets[i + 1]). Each detection takes
// its image's GT of highest IoU (the first on a tie); above `ovthresh` it
// is a TP where that GT is not difficult and not yet taken, an FP where it
// was taken, and neither where it is difficult; otherwise an FP. Writes
// tp and fp, (D,) 0/1 each.
void voc_match(const double* det_boxes, const int32_t* det_img, int64_t D,
               const double* gt_boxes, const uint8_t* gt_difficult,
               const int64_t* gt_offsets, int64_t n_images, double ovthresh,
               uint8_t* tp, uint8_t* fp) {
  std::vector<uint8_t> taken(static_cast<size_t>(gt_offsets[n_images]), 0);
  for (int64_t d = 0; d < D; ++d) {
    tp[d] = 0;
    fp[d] = 0;
    const int32_t im = det_img[d];
    if (im < 0 || im >= n_images) {
      fp[d] = 1;
      continue;
    }
    const double* box = det_boxes + 4 * d;
    double best = -1.0;
    int64_t arg = -1;
    for (int64_t g = gt_offsets[im]; g < gt_offsets[im + 1]; ++g) {
      const double ov = iou_voc(gt_boxes + 4 * g, box);
      if (ov > best) {
        best = ov;
        arg = g;
      }
    }
    if (arg < 0 || !(best > ovthresh)) {
      fp[d] = 1;
    } else if (!gt_difficult[arg]) {
      if (taken[arg]) {
        fp[d] = 1;
      } else {
        tp[d] = 1;
        taken[arg] = 1;
      }
    }
  }
}

// CorLoc of one class, on the arrays of voc_match: per image, only its
// first detection in the given order is judged, and only where the image
// has a non-difficult GT box of the class: 1 where its best IoU with any
// of the image's GT boxes exceeds `ovthresh`, else 0. Images not judged
// stay -1. Writes verdict, (n_images,).
void voc_corloc(const double* det_boxes, const int32_t* det_img, int64_t D,
                const double* gt_boxes, const uint8_t* gt_difficult,
                const int64_t* gt_offsets, int64_t n_images, double ovthresh,
                int8_t* verdict) {
  std::fill(verdict, verdict + n_images, static_cast<int8_t>(-1));
  for (int64_t d = 0; d < D; ++d) {
    const int32_t im = det_img[d];
    if (im < 0 || im >= n_images || verdict[im] != -1) continue;
    const int64_t g0 = gt_offsets[im], g1 = gt_offsets[im + 1];
    bool easy = false;
    for (int64_t g = g0; g < g1 && !easy; ++g) easy = !gt_difficult[g];
    if (!easy) continue;
    double best = -1.0;
    for (int64_t g = g0; g < g1; ++g)
      best = std::max(best, iou_voc(gt_boxes + 4 * g, det_boxes + 4 * d));
    verdict[im] = best > ovthresh ? 1 : 0;
  }
}

// One class in one image at T IoU thresholds, COCO's greedy rule: the D
// detections in descending score each take, among the GT boxes not yet
// taken (an ignored GT box may be taken again), the one of highest IoU at
// or above the threshold, a non-ignored one before an ignored one. A
// match to an ignored GT box marks the detection ignored, any other match
// a TP. Writes tp and ign, (T, D) 0/1 each.
void coco_match(const double* det_boxes, int64_t D, const double* gt_boxes,
                const uint8_t* gt_ignore, int64_t G, const double* iou_thrs,
                int64_t T, uint8_t* tp, uint8_t* ign) {
  std::vector<double> iou(static_cast<size_t>(D * G));
  for (int64_t d = 0; d < D; ++d)
    for (int64_t g = 0; g < G; ++g)
      iou[d * G + g] = iou_coco(gt_boxes + 4 * g, det_boxes + 4 * d);
  std::vector<uint8_t> taken(static_cast<size_t>(G));
  for (int64_t t = 0; t < T; ++t) {
    std::fill(taken.begin(), taken.end(), 0);
    for (int64_t d = 0; d < D; ++d) {
      double floor_iou = iou_thrs[t];
      int64_t arg = -1;
      for (int64_t g = 0; g < G; ++g) {
        if (taken[g] && !gt_ignore[g]) continue;
        const double ov = iou[d * G + g];
        if (!(ov >= floor_iou)) continue;
        if (arg >= 0 && !gt_ignore[arg] && gt_ignore[g]) continue;
        arg = g;
        floor_iou = ov;
      }
      tp[t * D + d] = 0;
      ign[t * D + d] = 0;
      if (arg < 0) continue;
      if (gt_ignore[arg]) {
        ign[t * D + d] = 1;
      } else {
        tp[t * D + d] = 1;
        taken[arg] = 1;
      }
    }
  }
}

}  // extern "C"
