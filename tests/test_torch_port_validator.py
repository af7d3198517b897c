"""The port's validator against the JAX package's on the golden checkpoint
and the same synthetic labelled images (rect batches at 160 px, a padded
final batch), f32: `seen` and the label count exact, the metrics within
1e-4; each path of the validator once."""

import numpy as np
import pytest
import torch

from _torch_port_common import GOLDEN, LABELLED_IMG, golden_variables, jax_model, labelled_set

torch.set_num_threads(1)

TOL = 1e-4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from ayolov2_tpu.models import fuse_params
    from ayolov2_torch.utils.checkpoint import load_model

    img_dir = labelled_set(tmp_path_factory.mktemp("labelled"))
    port = load_model(GOLDEN / "weights/best.ckpt", nc=20, device="cpu")
    return img_dir, port, jax_model("s", fused=True, nc=20), fuse_params(golden_variables())


def _port_result(img_dir, model, cfg, single_cls=False):
    from ayolov2_torch.data import DataLoader, DetectionDataset
    from ayolov2_torch.eval import YoloValidator

    ds = DetectionDataset(str(img_dir), img_size=LABELLED_IMG, batch_size=4, rect=True, pad=0.5,
                          single_cls=single_cls)
    result = YoloValidator(model, DataLoader(ds, batch_size=4), cfg=cfg, device="cpu").validation()
    return result, sum(len(lab) for lab in ds.labels)


def _jax_result(img_dir, model, variables, cfg, single_cls=False):
    from ayolov2_tpu.data import DataLoader, DetectionDataset
    from ayolov2_tpu.eval import YoloValidator

    ds = DetectionDataset(str(img_dir), img_size=LABELLED_IMG, batch_size=4, rect=True, pad=0.5,
                          single_cls=single_cls)
    return YoloValidator(model, variables, DataLoader(ds, batch_size=4), cfg=cfg).validation()


@pytest.mark.parametrize("cfg", [
    dict(fused=True),
    dict(fused=False, nms_type="nms"),
    dict(fused=False, nms_type="fast_nms"),
    dict(fused=False, nms_type="matrix_nms"),
    dict(fused=False, nms_type="merge_nms"),
    dict(hybrid_label=True),
    dict(single_cls=True),
], ids=["fused", "plain-nms", "plain-fast_nms", "plain-matrix_nms", "plain-merge_nms",
        "hybrid_label", "single_cls"])
def test_validator_matches_jax(setup, cfg):
    img_dir, port_model, jmodel, jvars = setup
    cfg = dict(cfg, half=False)
    single = cfg.get("single_cls", False)
    got, n_labels = _port_result(img_dir, port_model, dict(cfg, early_pipeline=False), single)
    want = _jax_result(img_dir, jmodel, jvars, cfg, single)
    assert got["seen"] == want["seen"] == 9  # 3 batches of 4, the last 1 real + 3 padding
    assert got["n_labels"] == n_labels > 10
    for key in ("mp", "mr", "map50", "map50_95"):
        assert abs(got[key] - want[key]) < TOL, (key, got[key], want[key])
    np.testing.assert_allclose(got["maps"], want["maps"], atol=TOL)
    assert len(got["t"]) == 3
    if not cfg.get("hybrid_label"):
        assert got["map50"] > 0.9  # the images are labelled with these weights' detections


def test_fused_path_with_the_early_network_in_bf16(setup):
    """The default path (bf16, the early network's plain version on the CPU)
    against bf16 without it: the gates the on-card check holds the kernel to
    (within 0.02, and mAP50 >= 0.9 on labels from the f32 path)."""
    img_dir, port_model, _, _ = setup
    plain, _ = _port_result(img_dir, port_model, dict(early_pipeline=False))
    default, _ = _port_result(img_dir, port_model, {})
    assert default["seen"] == plain["seen"] and default["n_labels"] == plain["n_labels"]
    for key in ("map50", "map50_95"):
        assert abs(default[key] - plain[key]) < 0.02, (key, default[key], plain[key])
    assert default["map50"] >= 0.9


def test_detection_fn_takes_the_models_place(setup):
    """A serving function given as ``detection_fn`` (no model) scores as the
    fused path that runs the same function."""
    from ayolov2_torch.data import DataLoader, DetectionDataset
    from ayolov2_torch.eval import YoloValidator
    from ayolov2_torch.export import make_serving_fn

    img_dir, port_model, _, _ = setup
    cfg = dict(half=False, early_pipeline=False)
    want, _ = _port_result(img_dir, port_model, cfg)
    serve = make_serving_fn(port_model, top_k=512, keep_top_k=300, image_dtype=torch.float32,
                            early_pipeline=False, multi_label=True, device="cpu")
    ds = DetectionDataset(str(img_dir), img_size=LABELLED_IMG, batch_size=4, rect=True, pad=0.5)
    got = YoloValidator(None, DataLoader(ds, batch_size=4), cfg=dict(cfg, nc=20),
                        detection_fn=serve, device="cpu").validation()
    for key in ("seen", "n_labels", "mp", "mr", "map50", "map50_95"):
        assert got[key] == want[key], key


def test_unported_options_raise(setup, tmp_path):
    """TTA and plots, refused until they were ported, now take the plain
    path and gather the confusion matrix; what the kernel path cannot do
    (take new weights into its packed copy) still raises."""
    from ayolov2_torch.eval import YoloValidator

    _, port_model, _, _ = setup
    tta = YoloValidator(port_model, None, cfg={"tta": True}, device="cpu")
    assert tta.tta and not tta.use_fused and tta.serve.early
    plots = YoloValidator(port_model, None, cfg={"plot_dir": str(tmp_path)}, device="cpu")
    assert plots.use_fused and plots.confusion is not None
    with pytest.raises(ValueError, match="packed weights"):
        tta.update_weights(port_model)


def test_validation_loss_matches_jax(setup):
    """``compute_loss``: the unfused golden model on the plain path, the
    validation loss (a padded final batch of 1 real image in 4) and the
    metrics against the JAX validator's."""
    from ayolov2_tpu.data import DataLoader as JaxLoader, DetectionDataset as JaxDataset
    from ayolov2_tpu.eval import YoloValidator as JaxValidator
    from ayolov2_tpu.loss.yolo_loss import ComputeLoss as JaxLoss
    from ayolov2_tpu.models.yolo_head import YOLOHead

    from _torch_port_common import port_model
    from ayolov2_torch.data import DataLoader, DetectionDataset
    from ayolov2_torch.eval import YoloValidator
    from ayolov2_torch.loss.yolo_loss import ComputeLoss
    from ayolov2_torch.train.trainer import scale_hyp_gains

    img_dir = setup[0]
    hyp = scale_hyp_gains({"box": 0.05, "cls": 0.5, "obj": 1.0, "anchor_t": 4.0}, 3, 20,
                          LABELLED_IMG)
    variables = golden_variables()
    jmodel = jax_model("s", nc=20)
    head = YOLOHead(nc=20, anchors=jmodel.anchors, strides=jmodel.strides)
    ds = JaxDataset(str(img_dir), img_size=LABELLED_IMG, batch_size=4, rect=True, pad=0.5)
    want = JaxValidator(jmodel, variables, JaxLoader(ds, batch_size=4), cfg=dict(half=False),
                        compute_loss=JaxLoss.from_hyp(head.stride_anchors(), 20, hyp)).validation()

    model = port_model("s", variables, nc=20)
    loss = ComputeLoss.from_hyp(model.head.stride_anchors(), 20, hyp)
    pds = DetectionDataset(str(img_dir), img_size=LABELLED_IMG, batch_size=4, rect=True, pad=0.5)
    v = YoloValidator(model, DataLoader(pds, batch_size=4), cfg=dict(half=False),
                      compute_loss=loss, device="cpu")
    assert not v.use_fused and not v.serve.early
    got = v.validation()
    assert len(pds) % 4 == 1  # the final batch is padded
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert min(got["loss"]) > 0
    for key in ("mp", "mr", "map50", "map50_95"):
        assert abs(got[key] - want[key]) < TOL, key
