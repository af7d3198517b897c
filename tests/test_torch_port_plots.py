"""Plots: the port's numpy rasteriser and PNG writer against OpenCV and the
JAX package's matplotlib figures.

- ``write_png`` read back by ``cv2.imread`` and by ``read_png`` gives the
  array written (BGR and gray);
- ``plot_images`` against JAX's file, both read by ``cv2.imread``: equal
  outside the drawn boxes and labels, each box's edges within one pixel;
- each chart at matplotlib's pixel size for JAX's figsize and dpi, with the
  curves, bars, scatter points and heat-map cells where the data put them;
- ``ap_per_class(plot=True)`` bit-equal to JAX's with the four curves
  written; ``cli.train`` with ``train_config.yaml``'s sections and
  ``plot: true`` writes ``labels.png`` and ``train_batch0-2.png``; ``cli.val
  --plot --dst`` and ``cli.val2 --plot`` / ``--export`` write the curves and
  the confusion matrix.
"""

import json
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from _torch_port_common import GOLDEN, LABELLED_IMG, ROOT, labelled_set, synthetic_image, train_files

torch.set_num_threads(1)

WEIGHTS = str(GOLDEN / "weights/best.ckpt")
CYCLE_BGR = [(180, 119, 31), (14, 127, 255)]  # matplotlib's C0, C1
BLUE = (255, 0, 0)


def _read(path) -> np.ndarray:
    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    assert img is not None, path
    return img


# ---- PNG -------------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(37, 53, 3), (29, 31)], ids=["bgr", "gray"])
def test_png_round_trip_through_cv2(tmp_path, shape):
    from ayolov2_torch.utils.png import read_png, write_png

    img = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    write_png(tmp_path / "port.png", img)
    np.testing.assert_array_equal(_read(tmp_path / "port.png"), img)
    np.testing.assert_array_equal(read_png(tmp_path / "port.png"), img)
    with pytest.raises(ValueError, match="uint8"):
        write_png(tmp_path / "bad.png", img.astype(np.float32))


# ---- boxes and mosaics ----------------------------------------------------------------


def _drawn(img: np.ndarray, base: np.ndarray) -> np.ndarray:
    return (img.astype(np.int16) - base).any(-1)


def _span(mask: np.ndarray) -> tuple:
    idx = np.flatnonzero(mask)
    return int(idx.min()), int(idx.max())


def test_plot_images_equals_jax_outside_the_labels(tmp_path):
    """A mosaic of 5 tiles (3 x 3 on white) with boxes of three classes:
    equal to JAX's outside what either draws; each box edge's drawn pixels
    (JAX's are anti-aliased) within one pixel of JAX's."""
    from ayolov2_tpu.utils import plots as jp
    from ayolov2_torch.utils import plots as pp

    rng = np.random.default_rng(2)
    h, w = 96, 128
    images = np.stack([synthetic_image(rng, h, w) for _ in range(5)])
    boxes = [(0, 0, 0.5, 0.55, 0.6, 0.5), (1, 1, 0.3, 0.6, 0.45, 0.5), (1, 2, 0.7, 0.45, 0.5, 0.6),
             (3, 0, 0.5, 0.5, 0.8, 0.7), (4, 2, 0.55, 0.6, 0.7, 0.5)]
    targets = np.zeros((8, 6), np.float32)
    targets[: len(boxes)] = boxes
    mask = np.arange(8) < len(boxes)
    names = ["cat", "dog", "bird"]
    jp.plot_images(images, targets, mask, tmp_path / "jax.png", names)
    pp.plot_images(images, targets, mask, tmp_path / "port.png", names)
    want, got = _read(tmp_path / "jax.png"), _read(tmp_path / "port.png")
    assert got.shape == want.shape == (3 * h, 3 * w, 3)

    base = np.full_like(want, 255)
    for i in range(5):
        r, c = divmod(i, 3)
        base[r * h: (r + 1) * h, c * w: (c + 1) * w] = images[i]
    dj, dp = _drawn(want, base), _drawn(got, base)
    outside = ~(dj | dp)
    np.testing.assert_array_equal(got[outside], want[outside])
    # JAX's anti-aliased lines change about twice the pixels; the port's lie
    # inside JAX's drawing grown by one pixel but for the labels' box heights
    grown = dj.copy()
    grown[1:] |= dj[:-1]
    grown[:-1] |= dj[1:]
    grown[:, 1:] |= grown[:, :-1].copy()
    grown[:, :-1] |= grown[:, 1:].copy()
    assert dp.sum() > 0.4 * dj.sum() and (dp & ~grown).sum() <= 0.1 * dp.sum()

    for img_i, cls, cx, cy, bw, bh in boxes:
        r, c = divmod(img_i, 3)
        x1, x2 = int((cx - bw / 2) * w), int((cx + bw / 2) * w)
        y1, y2 = int((cy - bh / 2) * h), int((cy + bh / 2) * h)
        ym, xm = (y1 + y2) // 2, x2 - 4  # clear of the label above the top-left corner
        tj, tp = dj[r * h: (r + 1) * h, c * w: (c + 1) * w], dp[r * h: (r + 1) * h, c * w: (c + 1) * w]
        for edge, lo, hi, line in (("left", x1 - 3, x1 + 4, ym), ("right", x2 - 3, x2 + 4, ym)):
            sj, sp = _span(tj[line, lo:hi]), _span(tp[line, lo:hi])
            assert abs(sj[0] - sp[0]) <= 1 and abs(sj[1] - sp[1]) <= 1, (edge, sj, sp)
        for edge, lo, hi in (("top", y1 - 3, y1 + 4), ("bottom", y2 - 3, y2 + 4)):
            sj, sp = _span(tj[lo:hi, xm]), _span(tp[lo:hi, xm])
            assert abs(sj[0] - sp[0]) <= 1 and abs(sj[1] - sp[1]) <= 1, (edge, sj, sp)
        color = np.array(pp.color_for(cls), np.uint8)
        assert (got[r * h + ym, c * w + x1] == color).all()


# ---- charts ----------------------------------------------------------------------------


def _frame(img: np.ndarray):
    """(x0, y0, x1, y1): the first two long black vertical lines and the
    first two long black horizontal lines (the axes' spines)."""
    black = (img == 0).all(-1)
    cols = np.flatnonzero(black.sum(0) > 0.4 * img.shape[0])
    rows = np.flatnonzero(black.sum(1) > 0.4 * img.shape[1])
    split_c = np.flatnonzero(np.diff(cols) > 1)
    split_r = np.flatnonzero(np.diff(rows) > 1)
    x0, x1 = cols[split_c[0]], cols[split_c[0] + 1]
    y0, y1 = rows[split_r[0]], rows[split_r[0] + 1]
    return int(x0), int(y0), int(x1), int(y1)


def _at(frame, fx, fy):
    """Pixel (x, y) of axes fraction (fx, fy), y up."""
    x0, y0, x1, y1 = frame
    return x0 + fx * (x1 - x0), y1 - fy * (y1 - y0)


def _pixels_of(img, color, frame):
    x0, y0, x1, y1 = frame
    inside = np.zeros(img.shape[:2], bool)
    inside[y0 + 2: y1 - 1, x0 + 2: x1 - 1] = True
    ys, xs = np.nonzero((img == np.array(color, np.uint8)).all(-1) & inside)
    return xs, ys


def _charts(module, tmp_path: Path, tag: str):
    """Each chart of ``module`` on the same data; {name: path}."""
    px = np.linspace(0, 1, 1000)
    paths = {k: tmp_path / f"{tag}_{k}.png" for k in ("histogram", "pr", "mc", "confusion")}
    labels = [np.array([[0, 0.5, 0.5, 0.2, 0.3], [1, 0.4, 0.5, 0.6, 0.7]]),
              np.array([[1, 0.5, 0.5, 0.4, 0.5]] * 5)]
    module.plot_label_histogram(labels, 3, paths["histogram"])
    py = [np.full(1000, 0.25), np.full(1000, 0.75)]
    module.plot_pr_curve(px, py, np.array([[0.5] * 10, [0.7] * 10]), paths["pr"], ["a", "b"])
    module.plot_mc_curve(px, np.stack([px * 0.5, px * 0.5 + 0.5]), paths["mc"], ["a", "b"],
                         ylabel="F1")
    module.plot_confusion_matrix(np.diag([5.0, 3.0, 2.0, 0.0]), paths["confusion"],
                                 ["a", "b", "c"])
    return paths


def test_charts_at_matplotlibs_pixel_size(tmp_path):
    from ayolov2_tpu.utils import plots as jp
    from ayolov2_torch.utils import plots as pp

    want, got = _charts(jp, tmp_path, "jax"), _charts(pp, tmp_path, "port")
    sizes = {"histogram": (600, 1440), "pr": (1200, 1800), "mc": (1200, 1800),
             "confusion": (1600, 2000)}
    for name, hw in sizes.items():
        assert _read(got[name]).shape == (*hw, 3), name  # matplotlib's files are RGBA
        assert _read(want[name]).shape[:2] == hw, name


@pytest.mark.parametrize("chart", ["pr", "mc"])
def test_curves_where_the_data_put_them(tmp_path, chart):
    """PR: precision 0.25 (C0) and 0.75 (C1), their mean 0.5 in blue; F1: the
    lines 0.5x (C0) and 0.5x + 0.5 (C1), their mean 0.5x + 0.25 in blue."""
    from ayolov2_torch.utils import plots as pp

    img = _read(_charts(pp, tmp_path, "port")[chart])
    frame = _frame(img)
    lines = {"pr": [(CYCLE_BGR[0], lambda x: 0.25 + 0 * x), (CYCLE_BGR[1], lambda x: 0.75 + 0 * x),
                    (BLUE, lambda x: 0.5 + 0 * x)],
             "mc": [(CYCLE_BGR[0], lambda x: 0.5 * x), (CYCLE_BGR[1], lambda x: 0.5 * x + 0.5),
                    (BLUE, lambda x: 0.5 * x + 0.25)]}[chart]
    x0, _, x1, _ = frame
    for color, fn in lines:
        xs, ys = _pixels_of(img, color, frame)
        assert len(xs) > 500, color
        fx = (xs - x0) / (x1 - x0)
        _, want_y = _at(frame, fx, fn(fx))
        assert np.abs(ys - want_y).max() <= 6, color  # 3-point lines are 8 pixels wide
        assert xs.min() - x0 <= 6 and x1 - xs.max() <= 6, color  # across the whole range
    assert (img[frame[1] + 10, frame[2] + 40:] != 255).any()  # the legend at the right


def test_histogram_bars_and_scatter_where_the_data_put_them(tmp_path):
    """Class counts 1, 6, 0 as bars (heights in proportion, centred on their
    class); each box's (w, h) as a blended point at its place."""
    from ayolov2_torch.utils import plots as pp

    img = _read(_charts(pp, tmp_path, "port")["histogram"])
    left = img[:, : img.shape[1] // 2]
    frame = _frame(left)
    xs, ys = _pixels_of(left, CYCLE_BGR[0], frame)
    x0, y0, x1, y1 = frame
    lo, hi = -0.5 - 0.15, 2.5 + 0.15
    heights = {}
    for c in (0, 1):
        cx = x0 + (c - lo) / (hi - lo) * (x1 - x0)
        col = xs[np.abs(xs - cx) < 5]
        assert len(col), c
        heights[c] = y1 - ys[np.abs(xs - cx) < 5].min()
    assert abs(heights[1] / heights[0] - 6) < 0.2
    right = img[:, img.shape[1] // 2:]
    frame = _frame(right)
    wh = np.array([[0.2, 0.3], [0.6, 0.7], [0.4, 0.5]])
    lo, hi = wh.min(0) - 0.05 * np.ptp(wh, 0), wh.max(0) + 0.05 * np.ptp(wh, 0)
    for w, h in wh:
        x, y = _at(frame, (w - lo[0]) / (hi[0] - lo[0]), (h - lo[1]) / (hi[1] - lo[1]))
        patch = right[int(y) - 3: int(y) + 4, int(x) - 3: int(x) + 4].astype(int)
        assert (patch.sum(-1) < 3 * 255).any(), (w, h)


def test_confusion_matrix_cells(tmp_path):
    """diag(5, 3, 2, 0) normalised by column: the three class cells full
    (the darkest blue), every other cell under 0.005 and white."""
    from ayolov2_torch.utils import plots as pp

    img = _read(_charts(pp, tmp_path, "port")["confusion"])
    x0, y0, x1, y1 = _frame(img)
    dark = pp.blues(np.array(1.0))
    cell = (x1 - x0) / 4
    for i in range(4):
        for j in range(4):
            px = img[int(y0 + (i + 0.5) * cell), int(x0 + (j + 0.5) * cell)]
            if i == j and i < 3:
                np.testing.assert_array_equal(px, dark)
            else:
                np.testing.assert_array_equal(px, [255, 255, 255])


def test_ap_per_class_plots_and_equals_jax(tmp_path):
    from ayolov2_tpu.utils.metrics import ap_per_class as jax_ap
    from ayolov2_torch.utils.metrics import ap_per_class

    rng = np.random.default_rng(4)
    tp = rng.random((60, 10)) < 0.6
    conf, pcls, tcls = rng.random(60), rng.integers(0, 3, 60), rng.integers(0, 3, 40)
    got = ap_per_class(tp, conf, pcls, tcls, plot=True, save_dir=tmp_path, names=["a", "b", "c"])
    want = jax_ap(tp, conf, pcls, tcls)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for name in ("PR_curve", "F1_curve", "P_curve", "R_curve"):
        assert _read(tmp_path / f"{name}.png").shape == (1200, 1800, 3)


# ---- the entry points -----------------------------------------------------------------


def test_train_cli_with_plot_true_writes_labels_and_batches(tmp_path):
    """``cli.train --device cpu`` with ``train_config.yaml`` as shipped but
    for epochs, batch and image size and the label files the set has (plot
    true, its augmentation, threads) on a tiny model: labels.png and the
    first three batches of epoch 0."""
    from ayolov2_torch.cli import train

    model_cfg, data, _ = train_files(tmp_path)
    text = (ROOT / "res/configs/cfg/train_config.yaml").read_text()
    for a, b in (("epochs: 300", "epochs: 1"), ("batch_size: 64", "batch_size: 2"),
                 ("image_size: 640", "image_size: 64"), ('label_type: "segments"', "label_type: labels"),
                 ("  plot: true", "  plot: true\n  half: false")):
        assert a in text
        text = text.replace(a, b, 1)
    cfg = tmp_path / "train_config.yaml"
    cfg.write_text(text)
    trainer = train.main(["--model", str(model_cfg), "--data", str(data), "--cfg", str(cfg),
                          "--log-dir", str(tmp_path / "runs"), "--device", "cpu"])
    run = trainer.log_dir
    assert _read(run / "labels.png").shape == (600, 1440, 3)
    for i in range(3):
        assert _read(run / f"train_batch{i}.png").shape == (128, 128, 3)
    assert not (run / "train_batch3.png").exists()
    assert (trainer.wdir / "best.ckpt").exists()


@pytest.fixture(scope="module")
def data_cfg(tmp_path_factory):
    root = tmp_path_factory.mktemp("plots_labelled")
    images = labelled_set(root)
    path = root / "data.json"
    path.write_text(json.dumps({"val_path": str(images), "nc": 20,
                                "names": [f"c{i}" for i in range(20)]}))
    return path


def test_val_cli_plot_writes_curves_and_confusion_under_dst(data_cfg, tmp_path):
    from ayolov2_torch.cli import val

    result = val.main(["--weights", WEIGHTS, "--data-cfg", str(data_cfg), "-iw", str(LABELLED_IMG),
                       "--batch-size", "4", "--device", "cpu", "--no-half", "--plot",
                       "--dst", str(tmp_path / "exp")])
    assert result["seen"] == 9 and result["map50"] > 0.9
    (run,) = (tmp_path / "exp" / "val").iterdir()
    assert run.name.endswith("_runs")
    for name, hw in (("PR_curve", (1200, 1800)), ("F1_curve", (1200, 1800)),
                     ("P_curve", (1200, 1800)), ("R_curve", (1200, 1800)),
                     ("confusion_matrix", (1600, 2000))):
        assert _read(run / f"{name}.png").shape == (*hw, 3), name


@pytest.mark.parametrize("flags", [["--plot"], ["--export", "EXPORT"]], ids=["plot", "export"])
def test_val2_cli_plot_and_export_write_theirs(data_cfg, tmp_path, flags):
    from ayolov2_torch.cli import val2

    flags = [str(tmp_path / "exported") if f == "EXPORT" else f for f in flags]
    metrics = val2.main(["--weights", WEIGHTS, "--data-cfg", str(data_cfg), "-iw",
                         str(LABELLED_IMG), "--batch-size", "4", "--device", "cpu", "--no-half",
                         "--json-path", str(tmp_path / "sheet.json"), "--dst",
                         str(tmp_path / "exp")] + flags)
    assert metrics["map50"] > 0.5
    out = tmp_path / "exported" if "--export" in flags else next((tmp_path / "exp/val2").iterdir())
    for name in ("PR_curve", "F1_curve", "P_curve", "R_curve", "confusion_matrix"):
        assert _read(out / f"{name}.png").ndim == 3, name
