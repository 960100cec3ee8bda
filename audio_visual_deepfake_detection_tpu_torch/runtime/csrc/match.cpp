// Greedy AP matching for temporal detection evaluation.
//
// Native equivalent of the per-video TP/FP matching inside the reference
// evaluators (libs/utils/metrics.py:255-336 and
// libs/utils/Evaluation/eval_detection.py:229-318): predictions are walked in
// descending score order; each grabs the highest-IoU still-unclaimed ground
// truth of its own video when the IoU reaches the threshold. Videos are
// independent (locks never cross videos), which makes the matching
// embarrassingly parallel over videos — this file parallelizes with OpenMP so
// the challenge-scale table (343k videos / ~34M predictions) evaluates in
// seconds instead of the reference's 16-process joblib fan-out.
//
// Tie rule: equal IoUs resolve to the EARLIER ground-truth index
// (deterministic; mirrors eval/detection.py::_match_one_video's stable sort).
//
// Plain C ABI, loaded via ctypes (runtime/host_match.py).

#include <cstddef>
#include <cstdint>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// p_seg:   (npred, 2) float64, grouped by video, score-descending in-group
// p_off:   (nvid+1,) int64 group offsets into p_seg
// g_seg:   (ngt, 2) float64, grouped by video
// g_off:   (nvid+1,) int64 group offsets into g_seg
// thr:     (nthr,) float64 tIoU thresholds
// tp:      out (nthr, npred) uint8, grouped prediction order
// returns 0 on success
int match_tp(const double* p_seg, const int64_t* p_off,
             const double* g_seg, const int64_t* g_off,
             int64_t nvid, int64_t npred,
             const double* thr, int nthr,
             int n_threads, uint8_t* tp) {
    if (nvid < 0 || npred < 0 || nthr <= 0) return 1;
#if defined(_OPENMP)
    if (n_threads > 0) omp_set_num_threads(n_threads);
#pragma omp parallel
#endif
    {
        std::vector<double> iou;
        std::vector<uint8_t> claimed;
#if defined(_OPENMP)
#pragma omp for schedule(dynamic, 64)
#endif
        for (int64_t v = 0; v < nvid; ++v) {
            const int64_t p0 = p_off[v], p1 = p_off[v + 1];
            const int64_t g0 = g_off[v], g1 = g_off[v + 1];
            const int64_t ng = g1 - g0;
            if (p1 <= p0) continue;
            if (ng <= 0) continue;  // tp rows stay 0 (all FP)
            iou.resize(static_cast<size_t>(ng));
            claimed.assign(static_cast<size_t>(ng) * nthr, 0);
            for (int64_t i = p0; i < p1; ++i) {
                const double ps = p_seg[2 * i], pe = p_seg[2 * i + 1];
                for (int64_t j = 0; j < ng; ++j) {
                    const double gs = g_seg[2 * (g0 + j)];
                    const double ge = g_seg[2 * (g0 + j) + 1];
                    const double lo = ps > gs ? ps : gs;
                    const double hi = pe < ge ? pe : ge;
                    const double inter = hi > lo ? hi - lo : 0.0;
                    const double uni = (pe - ps) + (ge - gs) - inter;
                    iou[static_cast<size_t>(j)] = inter / uni;
                }
                for (int t = 0; t < nthr; ++t) {
                    const double th = thr[t];
                    uint8_t* cl = claimed.data() + static_cast<size_t>(t) * ng;
                    int64_t best = -1;
                    double best_iou = -1.0;
                    for (int64_t j = 0; j < ng; ++j) {
                        if (cl[j] || iou[static_cast<size_t>(j)] < th) continue;
                        if (iou[static_cast<size_t>(j)] > best_iou) {
                            best_iou = iou[static_cast<size_t>(j)];
                            best = j;
                        }
                    }
                    if (best >= 0) {
                        cl[best] = 1;
                        tp[static_cast<int64_t>(t) * npred + i] = 1;
                    }
                }
            }
        }
    }
    return 0;
}

}  // extern "C"
