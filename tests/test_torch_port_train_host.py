"""The training slice's host side against the JAX package: the YAML reader
(against PyYAML on every config in the repository), the shuffled and
weighted loader orders, auto-anchor and the label weights."""


import numpy as np
import pytest
import torch
import yaml

from _torch_port_common import ROOT, write_image_set

torch.set_num_threads(1)

YAMLS = sorted(str(p.relative_to(ROOT)) for d in ("res/configs", "runs")
               for p in (ROOT / d).rglob("*.yaml"))


def test_the_configs_are_found():
    assert len(YAMLS) >= 40
    assert "res/configs/cfg/train_golden_memorize.yaml" in YAMLS


@pytest.mark.parametrize("rel", YAMLS)
def test_yaml_reader_equals_pyyaml(rel):
    from ayolov2_torch.utils.config import load_yaml

    with open(ROOT / rel, encoding="utf-8") as f:
        want = yaml.safe_load(f)
    assert load_yaml(ROOT / rel) == want


SNIPPETS = [
    "a: 5e-4\nb: 5.0e-4\nc: 1.0e+5\nd: 1.0e5\ne: 010\nf: 1_000\ng: 0x1F\nh: 0b101\n",
    "a: yes\nb: Off\nc: ~\nd:\ne: ''\nf: \"x\\ty\\u00e9\"\ng: 'it''s'\nh: .inf\ni: -.Inf\n",
    "a: 1:30\nb: 190:20:30.15\nc: +12\nd: -0\ne: 0o7\nf: null # comment\ng: 'a # b'\n",
    "x:\n- 1\n- 2\ny: &a [1, 2,\n  3]  # c\nz: *a\nw:\n  - a: 1\n    b: {c: d, e: }\n  - - 5\n    - 6\n",
    "[1, [2, 3], {a: b},\n  ]\n",
    "k: v\n\n# only a comment\nk2:\n  nested: true\n  list: [a, 'b', \"c\"]\n",
]


@pytest.mark.parametrize("i", range(len(SNIPPETS)))
def test_yaml_reader_resolves_scalars_as_pyyaml(i):
    from ayolov2_torch.utils.config import parse_yaml

    assert parse_yaml(SNIPPETS[i]) == yaml.safe_load(SNIPPETS[i])


@pytest.mark.parametrize("text,line", [("a: |\n  block\n", 1), ("a: 1\nb: !!str 2\n", 2),
                                       ("a: 1\n---\nb: 2\n", 2), ("a: 2001-12-14\n", 1),
                                       ("a: b\n  c\n", 2), ("a: 1\n\tb: 2\n", 2)])
def test_yaml_reader_raises_outside_its_subset(tmp_path, text, line):
    from ayolov2_torch.utils.config import load_yaml

    path = tmp_path / "bad.yaml"
    path.write_text(text)
    with pytest.raises(ValueError, match=rf"bad\.yaml(:{line})?"):
        load_yaml(path)


def test_run_dir_and_snapshot(tmp_path):
    import json

    from ayolov2_torch.utils.config import make_run_dir, snapshot_configs

    a = make_run_dir(tmp_path, "train")
    b = make_run_dir(tmp_path, "train")
    assert a != b and a.is_dir() and b.name.endswith("2")
    cfg_file = tmp_path / "cfg.yaml"
    cfg_file.write_text("x: 1\n")
    snapshot_configs(a, {"cfg": {"x": 1}}, {"cfg": cfg_file})
    assert json.loads((a / "args.json").read_text()) == {"cfg": {"x": 1}}
    assert (a / "cfg.yaml").read_text() == "x: 1\n"


# ---- the loader's orders --------------------------------------------------------

@pytest.fixture(scope="module")
def train_set(tmp_path_factory):
    """13 BMPs with 0-3 labels each of 5 classes."""
    root = tmp_path_factory.mktemp("train")
    rng = np.random.default_rng(4)
    sizes = [(48, 64), (64, 48), (64, 64), (40, 64)] * 3 + [(64, 64)]
    write_image_set(root, sizes, seed=4)
    (root / "labels").mkdir()
    for i in range(len(sizes)):
        rows = [f"{rng.integers(0, 5)} {rng.uniform(0.3, 0.7):.5f} {rng.uniform(0.3, 0.7):.5f} "
                f"{rng.uniform(0.02, 0.6):.5f} {rng.uniform(0.02, 0.6):.5f}"
                for _ in range(int(rng.integers(0 if i else 1, 4)))]
        (root / "labels" / f"{i + 1:06d}.txt").write_text("\n".join(rows) + "\n" if rows else "")
    return root / "images"


def _loaders(images, weights=None, **kw):
    from ayolov2_tpu.data import DataLoader as JaxLoader, DetectionDataset as JaxDataset

    from ayolov2_torch.data import DataLoader, DetectionDataset

    common = dict(img_size=64, batch_size=4, stride=32)
    jl = JaxLoader(JaxDataset(str(images), **common), batch_size=4, workers=1, **kw)
    tl = DataLoader(DetectionDataset(str(images), **common), batch_size=4, workers=1, **kw)
    if weights is not None:
        jl.sample_weights = tl.sample_weights = weights
    return jl, tl


@pytest.mark.parametrize("weighted", [False, True])
def test_shuffled_orders_equal_jax(train_set, weighted):
    """Two epochs of shuffled (or image-weighted) drop-last batches: the
    same items in the same order, the same images and targets."""
    from ayolov2_torch.utils.general import labels_to_image_weights

    weights = None
    if weighted:
        from ayolov2_torch.data import DetectionDataset

        ds = DetectionDataset(str(train_set), img_size=64, batch_size=4)
        weights = labels_to_image_weights(ds.labels, 5)
        assert weights.max() > weights.min()
    jl, tl = _loaders(train_set, weights, shuffle=True, drop_last=True, seed=3)
    assert len(jl) == len(tl) == 3
    for epoch in range(2):
        jb, tb = list(jl), list(tl)
        assert len(jb) == len(tb) == 3
        for a, b in zip(jb, tb):
            assert a.paths == b.paths
            np.testing.assert_array_equal(a.images, b.images)
            np.testing.assert_array_equal(a.targets, b.targets)
            np.testing.assert_array_equal(a.target_mask, b.target_mask)
        assert jl.epoch == tl.epoch == epoch + 1
    orders = [[p for b in tl for p in b.paths] for _ in range(2)]
    assert orders[0] != orders[1]  # a new order every epoch


def test_get_item_and_epoch(train_set):
    from ayolov2_torch.data import DetectionDataset

    ds = DetectionDataset(str(train_set), img_size=64, batch_size=4, seed=2)
    a, b = ds.get_item(3, 0), ds.get_item(3, 17)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], ds[3][1])
    assert ds.seed == 2 and ds.epoch == 0 and len(ds.indices) == len(ds)


# ---- auto-anchor and label weights ------------------------------------------------

def test_kmean_anchors_equal_jax():
    from ayolov2_tpu.utils.anchors import kmean_anchors as jax_kmeans

    from ayolov2_torch.utils.anchors import bpr_aat, kmean_anchors

    rng = np.random.default_rng(0)
    wh = np.abs(np.concatenate([rng.normal(20, 1.5, (300, 2)), rng.normal(120, 8, (300, 2))])) + 2
    got = kmean_anchors(wh=wh, n=6, thr=4.0, gen=300, seed=1)
    np.testing.assert_array_equal(got, jax_kmeans(wh=wh, n=6, thr=4.0, gen=300, seed=1))
    assert np.all(np.diff(got.prod(1)) >= 0)
    assert bpr_aat(got, wh, 4.0)[0] > 0.99


@pytest.mark.parametrize("scale", [1.0, 0.05])
def test_check_anchors_equal_jax(train_set, scale):
    """The default anchors at their scale, and shrunk 20x (a refit)."""
    from ayolov2_tpu.data import DetectionDataset as JaxDataset
    from ayolov2_tpu.utils.anchors import check_anchors as jax_check

    from ayolov2_torch.data import DetectionDataset
    from ayolov2_torch.utils.anchors import check_anchors

    anchors = np.array([[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59, 119],
                        [116, 90, 156, 198, 373, 326]], np.float32).reshape(3, 3, 2) * scale
    got, changed = check_anchors(DetectionDataset(str(train_set), img_size=64), anchors,
                                 [8, 16, 32], img_size=64)
    want, changed_j = jax_check(JaxDataset(str(train_set), img_size=64), anchors, [8, 16, 32],
                                img_size=64)
    assert changed == changed_j
    np.testing.assert_array_equal(got, want)
    if scale < 1:
        assert changed


def test_label_weights_equal_jax(train_set):
    from ayolov2_tpu.utils.general import labels_to_class_weights as jcw
    from ayolov2_tpu.utils.general import labels_to_image_weights as jiw

    from ayolov2_torch.data import DetectionDataset
    from ayolov2_torch.utils.general import labels_to_class_weights, labels_to_image_weights

    labels = DetectionDataset(str(train_set), img_size=64).labels
    cw = labels_to_class_weights(labels, 6)
    np.testing.assert_array_equal(cw, jcw(labels, 6))
    np.testing.assert_array_equal(labels_to_image_weights(labels, 6, cw), jiw(labels, 6, cw))


def test_init_seeds():
    from ayolov2_torch.utils.general import init_seeds

    init_seeds(5)
    a = (np.random.random(), torch.rand(1))
    gen = init_seeds(5)
    assert np.random.random() == a[0] and torch.equal(torch.rand(1), a[1])
    assert gen.random() == np.random.default_rng(5).random()
