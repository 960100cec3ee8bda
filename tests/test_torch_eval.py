"""PyTorch port, evaluation and submission files vs the JAX package on the
CPU, exactly: segment IoU, the interpolated AP, AP / mAP with both matchers,
``ANETdetection`` with top-k recall, AR@N, the annotation and fusion
helpers, the ANet JSON loaders, ``build_proposal_json`` /
``evaluation_proposal`` / ``run_evaluation`` (their files byte for byte),
``items_to_table`` and ``generate_results``' two files byte for byte."""

import json
import os

import numpy as np
import pytest

from audio_visual_deepfake_detection_tpu.eval import challenge as jch
from audio_visual_deepfake_detection_tpu.eval import detection as jdet
from audio_visual_deepfake_detection_tpu.eval import io as jio
from audio_visual_deepfake_detection_tpu.infer import results as jres
from audio_visual_deepfake_detection_tpu.infer.runner import items_to_table as j_items_to_table
from audio_visual_deepfake_detection_tpu_torch.eval import challenge as tch
from audio_visual_deepfake_detection_tpu_torch.eval import detection as tdet
from audio_visual_deepfake_detection_tpu_torch.eval import io as tio
from audio_visual_deepfake_detection_tpu_torch.infer import results as tres
from audio_visual_deepfake_detection_tpu_torch.infer.runner import items_to_table


def _records(rng, n_vid=30):
    """GT records in the dataset's format and result items around them:
    near-GT detections, noise, ties and videos without detections."""
    gt, items = [], []
    for v in range(n_vid):
        vid = f"dev/id{v:05d}/x.mp4"
        n = int(rng.integers(0, 4))
        segs = []
        for _ in range(n):
            s = float(rng.uniform(0, 15))
            segs.append([s, s + float(rng.uniform(0.3, 3))])
        gt.append({"video_id": vid, "n_fakes": n,
                   "segments_time": np.asarray(segs, np.float32) if n else None})
        dets = [[a + float(rng.normal(0, 0.2)), b + float(rng.normal(0, 0.2))] for a, b in segs]
        dets += [[s, s + float(rng.uniform(0.1, 2))] for s in rng.uniform(0, 15, rng.integers(0, 8))]
        scores = [round(float(x), 3) for x in rng.uniform(0, 1, len(dets))]
        order = np.argsort(scores)[::-1]
        if v % 7 == 3:
            dets, scores = [], []
        items.append({"video_id": vid, "video_cls": [float(rng.normal(0, 3))],
                      "scores": [scores[i] for i in order] if scores else [],
                      "segments": [dets[i] for i in order] if dets else []})
    return gt, items


@pytest.fixture(scope="module")
def tables():
    gt, items = _records(np.random.default_rng(11))
    table = items_to_table(items)
    return gt, items, table


def test_items_to_table_matches_jax(tables):
    _, items, table = tables
    ref = j_items_to_table(items)
    assert set(table) == set(ref)
    for k in ref:
        assert np.asarray(table[k]).dtype == np.asarray(ref[k]).dtype
        assert np.array_equal(table[k], ref[k]), k
    empty = items_to_table([])
    assert all(np.array_equal(empty[k], j_items_to_table([])[k]) for k in empty)


def test_segment_iou_and_interpolated_ap_match_jax():
    rng = np.random.default_rng(0)
    cands = np.sort(rng.uniform(0, 10, (50, 2)), axis=1)
    for target in cands[:5]:
        assert np.array_equal(tdet.segment_iou(target, cands), jdet.segment_iou(target, cands))
    for _ in range(5):
        prec, rec = rng.uniform(0, 1, 20), np.sort(rng.uniform(0, 1, 20))
        assert tdet.interpolated_prec_rec(prec, rec) == jdet.interpolated_prec_rec(prec, rec)


@pytest.mark.parametrize("native", [True, False])
def test_anet_detection_matches_jax(tables, native):
    """mAP at the challenge tIoUs, and at ten tIoUs with top-k recall, both
    matchers; exact floats."""
    gt, _, table = tables
    for tious, top_k in ((tdet.CHALLENGE_TIOUS, ()), (np.linspace(0.5, 0.95, 10), (1, 5))):
        ours = tdet.ANETdetection(gt, tiou_thresholds=tious, native=native)
        ref = jdet.ANETdetection(gt, tiou_thresholds=tious, n_jobs=-1 if native else 0)
        got, want = ours.evaluate(table, top_k=top_k), ref.evaluate(table, top_k=top_k)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
        assert got[2] == want[2] and 0 < got[2] < 1
        if top_k:
            assert np.array_equal(ours.recall, ref.recall)


def test_multiclass_and_perfect_predictions(tables):
    gt, _, table = tables
    labels = np.arange(len(table["score"])) % 2
    two = dict(table, label=labels)
    ours = tdet.ANETdetection(gt, num_classes=2).evaluate(two)
    ref = jdet.ANETdetection(gt, num_classes=2).evaluate(two)
    assert np.array_equal(ours[0], ref[0]) and ours[2] == ref[2]
    # the ground truth fed back as the predictions scores exactly 1.0
    perfect = {"video-id": [], "t-start": [], "t-end": [], "label": [], "score": []}
    for rec in gt:
        for s, e in (rec["segments_time"] if rec["n_fakes"] else []):
            for k, v in zip(perfect, (rec["video_id"], float(s), float(e), 0, 1.0)):
                perfect[k].append(v)
    perfect = {k: np.asarray(v) for k, v in perfect.items()}
    _, m_ap, avg = tdet.ANETdetection(gt).evaluate(perfect)
    assert avg == 1.0 and m_ap.tolist() == [1.0] * 4


def test_recall_helpers_match_jax(tables):
    gt_records, _, table = tables
    ev = tdet.ANETdetection(gt_records)
    tious = np.linspace(0.5, 0.95, 10)
    assert np.array_equal(tdet.topkx_recall(ev.gt, table, tious, (1, 3, 5)),
                          jdet.topkx_recall(ev.gt, table, tious, (1, 3, 5)))
    for n in (10, 100):
        got = tdet.average_recall_vs_nr_proposals(ev.gt, table, tious, n)
        want = jdet.average_recall_vs_nr_proposals(ev.gt, table, tious, n)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
    assert tch.evaluation_proposal(table, gt_records) == \
        jch.evaluation_proposal(table, gt_records)


def test_annotation_and_fusion_helpers_match_jax(tables):
    _, _, table = tables
    ants = [{"segment": [1.0, 2.0], "label_id": 0}, {"segment": [1.0005, 2.0], "label_id": 0},
            {"segment": [3.0, 3.0], "label_id": 0}, {"segment": [1.0, 2.0], "label_id": 1}]
    assert tdet.remove_duplicate_annotations(ants) == jdet.remove_duplicate_annotations(ants)
    for num_pred in (200, 3):
        got = tdet.results_to_array(table, num_pred)
        want = jdet.results_to_array(table, num_pred)
        assert list(got) == list(want)
        for vid in want:
            for k in want[vid]:
                assert np.array_equal(got[vid][k], want[vid][k])
        cls = {vid: list(np.linspace(0.1, 0.9, 1 + i % 3)) for i, vid in enumerate(want)}
        fused = tdet.postprocess_results_with_cls(got, cls, num_pred, topk=2)
        ref = jdet.postprocess_results_with_cls(want, cls, num_pred, topk=2)
        for k in ref:
            assert np.array_equal(fused[k], ref[k]), k


def test_json_io_matches_jax(tables, tmp_path):
    gt_records, _, table = tables
    db = {"database": {r["video_id"]: {
        "subset": "Validation" if i % 3 else "train",
        "annotations": [{"segment": [float(s), float(e)], "label_id": 0}
                        for s, e in (r["segments_time"] if r["n_fakes"] else [])]}
        for i, r in enumerate(gt_records)}}
    (tmp_path / "gt.json").write_text(json.dumps(db))
    proposal = tch.build_proposal_json(table)
    (tmp_path / "pred.json").write_text(json.dumps(proposal))
    for split in (None, "validation"):
        got = tio.load_gt_seg_from_json(str(tmp_path / "gt.json"), split)
        want = jio.load_gt_seg_from_json(str(tmp_path / "gt.json"), split)
        assert all(np.array_equal(got[k], want[k]) for k in want)
    got = tio.load_pred_seg_from_json(str(tmp_path / "pred.json"))
    want = jio.load_pred_seg_from_json(str(tmp_path / "pred.json"))
    assert all(np.array_equal(got[k], want[k]) for k in want)


def test_run_evaluation_matches_jax(tables, tmp_path):
    """Proposal JSON and summary byte for byte, the returned mAP equal, with
    and without an external class-score file."""
    gt_records, _, table = tables
    cls_file = tmp_path / "cls.json"
    cls_file.write_text(json.dumps({r["video_id"]: [0.5 + 0.01 * i]
                                    for i, r in enumerate(gt_records)}))
    assert tch.build_proposal_json(table, top_per_video=3) == \
        jch.build_proposal_json(table, top_per_video=3)
    for cls in (None, str(cls_file)):
        outs = []
        for mod, tag in ((tch, "ours"), (jch, "ref")):
            path = str(tmp_path / tag / "eval.json")
            outs.append((mod.run_evaluation(table, gt_records, path, cls_score_file=cls,
                                            verbose=False), path))
        (got, gp), (want, wp) = outs
        assert got == want and 0 < got[0] < 100
        for a, b in ((gp, wp), (gp.replace(".json", ".txt"), wp.replace(".json", ".txt"))):
            assert open(a, "rb").read() == open(b, "rb").read()


def test_generate_results_matches_jax_byte_for_byte(tables, tmp_path):
    """Two shards, one with per-host folders and a duplicated video: both
    submission files equal the JAX package's byte for byte."""
    _, items, _ = tables
    items = [dict(it, video_cls=v) for it, v in zip(items, [[9.0], [-9.0], [2.2], 0.5] * 10)]
    outs = {}
    for tag, mod in (("ours", tres), ("ref", jres)):
        base = tmp_path / tag
        for sub, chunk in (("1", items[:12]), ("1/host0", items[12:20]),
                           ("1/host1", items[20:] + items[:1]), ("2", [])):
            os.makedirs(base / sub, exist_ok=True)
            (base / sub / "data_left.json").write_text(json.dumps(chunk))
        counts = mod.generate_results(str(base), num_shards=2)
        outs[tag] = (counts, (base / "prediction.txt").read_bytes(),
                     (base / "prediction.json").read_bytes())
    assert outs["ours"] == outs["ref"]
    assert outs["ours"][0] == (len(items), len(items))
    lines = outs["ours"][1].decode().splitlines()
    assert lines == sorted(lines) and lines[0].startswith("dev/id00000/x.mp4;1.0")
    pred = json.loads(outs["ours"][2])
    assert any(v == [[0, 0, 0]] for v in pred.values())
    assert all(s > 0.2 for v in pred.values() for s, _, _ in v if v != [[0, 0, 0]])
