"""The port's metrics and result writer against the JAX package's, on the
same numpy inputs: every number equal, not close."""

import json

import numpy as np
import pytest

from ayolov2_tpu.utils import metrics as jm
from ayolov2_tpu.utils import result_writer as jrw
from ayolov2_torch.utils import metrics as pm
from ayolov2_torch.utils import result_writer as prw


def _assert_same(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_same(a, b)
    elif isinstance(want, (str, int, float)):
        assert type(got) is type(want) and got == want
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _random_stats(seed, n_det=400, n_lab=150, nc=6):
    rng = np.random.default_rng(seed)
    tp = rng.random((n_det, 10)) < np.linspace(0.8, 0.2, 10)
    conf = rng.random(n_det).round(3)  # ties in confidence
    pred_cls = rng.integers(0, nc, n_det).astype(np.float64)
    target_cls = rng.integers(0, nc + 1, n_lab).astype(np.float64)  # a class never predicted
    return tp, conf, pred_cls, target_cls


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ap_per_class_and_compute_ap_equal_jax(seed):
    tp, conf, pred_cls, target_cls = _random_stats(seed)
    _assert_same(pm.ap_per_class(tp, conf, pred_cls, target_cls),
                 jm.ap_per_class(tp, conf, pred_cls, target_cls))
    rec = np.sort(np.random.default_rng(seed).random(50))
    prec = np.random.default_rng(seed + 9).random(50)
    _assert_same(pm.compute_ap(rec, prec), jm.compute_ap(rec, prec))


def _boxes(rng, n, size=200.0):
    xy = rng.uniform(0, size, (n, 2))
    wh = rng.uniform(2, size / 3, (n, 2))
    return np.concatenate([xy, xy + wh], 1)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_tp_matrices_and_confusion_equal_jax(seed):
    rng = np.random.default_rng(seed)
    labels = np.concatenate([rng.integers(0, 3, (12, 1)), _boxes(rng, 12)], 1)
    near = labels[:, 1:][rng.integers(0, 12, 30)] + rng.normal(0, 4, (30, 4))
    dets = np.concatenate([np.concatenate([near, _boxes(rng, 10)]),
                           rng.random((40, 1)), rng.integers(0, 3, (40, 1))], 1)
    _assert_same(pm.process_batch(dets, labels), jm.process_batch(dets, labels))
    _assert_same(pm.check_correct_prediction_by_iou(dets, labels),
                 jm.check_correct_prediction_by_iou(dets, labels))
    for args in ((dets[:0], labels), (dets, labels[:0])):
        _assert_same(pm.process_batch(*args), jm.process_batch(*args))
    a, b = pm.ConfusionMatrix(3), jm.ConfusionMatrix(3)
    for d, lab in ((dets, labels), (dets[:5], labels[:3]), (dets[:0], labels)):
        a.process_batch(d, lab)
        b.process_batch(d, lab)
    _assert_same(a.matrix, b.matrix)


def _coco_pair(seed, cat_ids):
    """GT with crowd boxes and all three area ranges, and predictions near
    it plus misses, more than 100 for some image and class."""
    rng = np.random.default_rng(seed)
    images, anns, preds = [], [], []
    for img_id in range(1, 7):
        images.append({"id": img_id, "width": 640, "height": 480})
        for k in range(int(rng.integers(0, 9))):
            side = rng.choice([12.0, 50.0, 150.0]) * rng.uniform(0.7, 1.3)
            x, y = rng.uniform(0, 400, 2)
            cat = int(rng.choice(cat_ids[:4]))
            anns.append({"id": len(anns) + 1, "image_id": img_id, "category_id": cat,
                         "bbox": [x, y, side, side * rng.uniform(0.5, 1.5)],
                         "area": float(side * side), "iscrowd": int(rng.random() < 0.15)})
            for _ in range(int(rng.integers(0, 3))):
                preds.append({"image_id": img_id, "category_id": cat,
                              "bbox": [x + rng.normal(0, 3), y + rng.normal(0, 3), side, side],
                              "score": round(float(rng.random()), 4)})
        for _ in range(int(rng.integers(0, 130 if img_id == 3 else 6))):
            x, y = rng.uniform(0, 500, 2)
            preds.append({"image_id": img_id, "category_id": int(rng.choice(cat_ids[:4])),
                          "bbox": [x, y, 30.0, 40.0], "score": float(rng.random())})
    gt = {"images": images, "annotations": anns,
          "categories": [{"id": c, "name": f"c{c}"} for c in cat_ids]}
    return gt, preds


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_det", [100, 10])
def test_coco_evaluator_equals_jax(seed, max_det, tmp_path):
    cat_ids = [1, 3, 7, 9, 11]
    gt, preds = _coco_pair(seed, cat_ids)
    gt_path = tmp_path / "gt.json"
    gt_path.write_text(json.dumps(gt))
    got = pm.COCOmAPEvaluator(str(gt_path)).evaluate(preds, max_det=max_det)
    want = jm.COCOmAPEvaluator(str(gt_path)).evaluate(preds, max_det=max_det)
    assert got == want
    assert 0 < got["map50"] < 1 and got["map_small"] != got["map_large"]
    got = pm.COCOmAPEvaluator(gt).evaluate_per_class(preds)
    want = jm.COCOmAPEvaluator(gt).evaluate_per_class(preds)
    _assert_same(got, want)
    table = pm.COCOmAPEvaluator.print_result(got)
    _assert_same(table, jm.COCOmAPEvaluator.print_result(want))


def test_coco_evaluator_maps_yolo_ids_and_rejects_foreign_ones():
    gt, preds = _coco_pair(5, [1, 2, 3, 4, 5])
    yolo = [dict(p, category_id=p["category_id"] - 1) for p in preds]
    got = pm.COCOmAPEvaluator(gt, cat_from_yolo=True).evaluate(yolo)
    assert got == jm.COCOmAPEvaluator(gt, cat_from_yolo=True).evaluate(yolo)
    with pytest.raises(KeyError, match="category_id 77"):
        pm.COCOmAPEvaluator(gt).evaluate_per_class(preds + [dict(preds[0], category_id=77)])


def test_result_writer_and_gt_json_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    paths = [str(tmp_path / f"{i:06d}.bmp") for i in (3, 17, 250)]
    det = np.zeros((3, 20, 6), np.float32)
    det[..., :4] = np.sort(rng.uniform(0, 160, (3, 20, 2, 2)), axis=2).reshape(3, 20, 4)
    det[..., 4] = rng.random((3, 20))
    det[..., 5] = rng.integers(0, 20, (3, 20))
    counts = np.array([20, 0, 7])
    metas = [((120, 150), ((0.8, 0.8), (20.0, 16.0))), ((160, 160), ((1.0, 1.0), (0.0, 0.0))),
             ((100, 76), ((1.6, 1.6), (19.2, 0.0)))]
    outs = []
    for mod in (prw, jrw):
        writer = mod.ResultWriter(tmp_path / f"{mod.__name__}.json")
        writer.start()
        writer.add_outputs(paths[:2], det[:2], counts[:2], (128, 160), metas[:2])
        writer.add_outputs(paths[2:], det[2:], counts[2:], (160, 128), metas[2:])
        outs.append(writer.close())
    assert outs[0] == outs[1] and len(outs[0]) == 27
    assert json.loads((tmp_path / f"{prw.__name__}.json").read_text()) == outs[0]
    assert {r["image_id"] for r in outs[0]} == {3, 250}
    assert prw.image_id_from_path("a/b/000123.jpg") == 123

    first = rng.uniform(0.1, 0.9, (4, 5)).astype(np.float32)
    first[:, 0] = [0, 4, 4, 11]

    class Labelled:
        img_files = paths
        shapes = np.array([[150, 120], [160, 160], [76, 100]])
        labels = [first, np.zeros((0, 5), np.float32), np.array([[19, 0.5, 0.5, 0.2, 0.3]], np.float32)]

    for from_yolo in (True, False):
        assert (prw.yolo_labels_to_coco_json(Labelled, from_yolo)
                == jrw.yolo_labels_to_coco_json(Labelled, from_yolo))


def test_result_writer_raises_what_its_thread_raised(tmp_path):
    """A batch that fails in the consumer thread (a class with no COCO id)
    neither blocks later batches nor leaves a partial answersheet."""
    det = np.zeros((1, 2, 6), np.float32)
    det[0, :, 2:4] = 10.0
    det[0, 1, 5] = 200  # no COCO category id
    writer = prw.ResultWriter(tmp_path / "sheet.json")
    writer.start()
    for _ in range(100):  # more than the queue holds
        writer.add_outputs(["000001.bmp"], det, np.array([2]), (32, 32),
                           [((32, 32), ((1.0, 1.0), (0.0, 0.0)))])
    with pytest.raises(IndexError):
        writer.close()
    assert not (tmp_path / "sheet.json").exists()
