"""The data side of the port's ranks (gloo, on the CPU): the loader's
shards over an uneven dataset, sharded serving and the split render.

- 4 ranks over 18 items at a global batch of 16 run 2 batches each (the
  shards are padded to equal length), every rank sees the same items, and
  the first global batch (items 0-15) gives the one-rank loss (JAX's
  ``test_four_process_cluster_uneven_dataset``);
- ``make_sharded_serving_fn`` on 2 ranks, gathered, equals
  ``make_serving_fn`` on the whole batch, float and int8; an indivisible
  batch raises;
- ``make_render_fn(mesh=)`` on 2 ranks, gathered, equals the one-device
  render bit for bit in both modes, and JAX's ``make_render_fn(mesh=)``
  over 2 devices within the render gates of ``test_torch_port_augment.py``
  (f32: max|d| <= 1 and at most 1e-3 of the pixels differ)."""

import json

import numpy as np
import pytest
import torch

from _torch_parallel_common import HYP, OPT, flat, rel, run_ranks, tiny_cfg, write_case

torch.set_num_threads(1)


def test_four_ranks_uneven_dataset(tmp_path):
    from _torch_parallel_worker import ToyDataset

    from ayolov2_torch.data.loader import DataLoader
    from ayolov2_torch.loss.yolo_loss import ComputeLoss
    from ayolov2_torch.models import build_model, init_model
    from ayolov2_torch.train.optimizer import build_optimizer
    from ayolov2_torch.train.train_state import create_train_state, make_train_step
    from ayolov2_torch.utils.weights import flax_from_state_dict

    model = init_model(build_model(tiny_cfg(), device="cpu"), seed=0)
    write_case(tmp_path, flax_from_state_dict(model.state_dict()), [], n_items=18, global_bs=16)
    run_ranks("loader", 4, tmp_path)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(4)]
    assert [int(r["n_batches"][0]) for r in ranks] == [2, 2, 2, 2]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["items"], ranks[0]["items"])
    loss = ComputeLoss.from_hyp(model.head.stride_anchors(), model.nc, HYP)
    state = create_train_state(model, build_optimizer(model, HYP, epochs=3, **OPT))
    step = make_train_step(loss, image_dtype=torch.float32)
    first = next(iter(DataLoader(ToyDataset(18), batch_size=16, max_labels_per_image=4,
                                 workers=1)))
    want = step(state, *(torch.from_numpy(a) for a in
                         (first.images, first.targets, first.target_mask))).numpy()
    assert rel(ranks[0]["items"][0], want) < 1e-4
    assert np.isfinite(ranks[0]["items"]).all()


def test_sharded_serving_equals_one_device(tmp_path):
    from ayolov2_torch.compress.quantize import quantize_model
    from ayolov2_torch.export import make_serving_fn
    from ayolov2_torch.models import build_model
    from ayolov2_torch.utils.weights import load_flax_variables

    from ayolov2_torch.models import init_model
    from ayolov2_torch.utils.weights import flax_from_state_dict

    variables = flax_from_state_dict(
        init_model(build_model(tiny_cfg(), device="cpu"), seed=0).state_dict())
    rng = np.random.default_rng(1)
    x = rng.integers(0, 255, (4, 64, 64, 3), np.uint8)
    calib = rng.random((2, 64, 64, 3)).astype(np.float32)
    tmp_path.mkdir(exist_ok=True)
    (tmp_path / "case.json").write_text(json.dumps({"model_cfg": tiny_cfg()}))
    np.savez(tmp_path / "vars.npz", **flat(variables))
    np.savez(tmp_path / "batches.npz", images=x, calib=calib)
    run_ranks("serve", 2, tmp_path)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    kw = dict(conf_thres=1e-5, iou_thres=0.65, nms_box=1000, keep_top_k=10, top_k=32,
              image_dtype=torch.float32, fused_decode=True, device="cpu")
    model = load_flax_variables(build_model(tiny_cfg(), device="cpu"), variables).fuse()
    from ayolov2_torch.ops.early_pipeline import can_fuse_early_model

    # its head reads layer 3: the early kernel (layers 0-3 alone) is not for it
    assert not can_fuse_early_model(model) and 3 in model.save
    qmodel, _ = quantize_model(tiny_cfg(), variables,
                               [torch.from_numpy(calib).permute(0, 3, 1, 2)],
                               dtype=torch.float32, device="cpu")
    for prefix, m in (("", model), ("q", qmodel)):
        det, n = (t.numpy() for t in make_serving_fn(m, **kw)(torch.from_numpy(x)))
        got_det, got_n = ranks[0][f"{prefix}det"], ranks[0][f"{prefix}n"]
        assert got_det.shape == det.shape and n.sum() > 0
        np.testing.assert_array_equal(got_n, n)
        np.testing.assert_allclose(got_det, det, atol=1e-5, rtol=1e-5)
        # rank 1 keeps its own rows
        np.testing.assert_array_equal(ranks[1][f"{prefix}n"], n[2:])
    assert all(int(r["indivisible"][0]) == 1 for r in ranks)


@pytest.fixture(scope="module")
def plans(tmp_path_factory):
    """36 plans of the shared labelled set (mosaic, mixup, flips, an
    axis-aligned warp) from the JAX package's and the port's datasets."""
    from test_torch_port_augment import AXIS_ALIGNED, FLIPS, _datasets, _plans

    from _torch_port_common import labelled_set

    images = labelled_set(tmp_path_factory.mktemp("render"))
    jax_ds, port_ds = _datasets(images, dict(AXIS_ALIGNED, mosaic=0.5, mixup=0.5), FLIPS)
    return jax_ds, port_ds, _plans(jax_ds, epochs=(0, 1)), _plans(port_ds, epochs=(0, 1))


def test_split_render_equals_one_device_and_jax(tmp_path, plans):
    import jax

    from ayolov2_tpu.data.device_augment import collate_plans as jax_collate
    from ayolov2_tpu.data.device_augment import make_render_fn as jax_render_fn
    from ayolov2_tpu.parallel import get_mesh

    from _torch_port_common import LABELLED_IMG
    from ayolov2_torch.data.device_augment import collate_plans, make_render_fn

    jax_ds, port_ds, plans_j, plans_p = plans
    pb, jb = collate_plans(plans_p, len(plans_p), 64), jax_collate(plans_j, len(plans_j), 64)
    keys = ("src_idx", "rects", "offs", "minv", "blend", "hsv", "flips")
    arrs = {k: np.asarray(getattr(pb, k)) for k in keys}
    arrs["frames"] = np.asarray(port_ds.resident_frames)
    tmp_path.mkdir(exist_ok=True)
    (tmp_path / "case.json").write_text(json.dumps(
        {"img": LABELLED_IMG, "frame": LABELLED_IMG, "pairs": 2}))
    np.savez(tmp_path / "batches.npz", **arrs)
    run_ranks("render", 2, tmp_path)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    args = [torch.from_numpy(arrs[k]) for k in ("frames",) + keys]
    mesh = get_mesh(jax.devices()[:2])
    jargs = [jax_ds.resident_frames] + [np.asarray(getattr(jb, k)) for k in keys]
    for mode in ("gather", "separable"):
        assert int(ranks[0][f"{mode}_rows"][0]) == len(plans_p) // 2
        one = make_render_fn(LABELLED_IMG, LABELLED_IMG, 2, mode)(*args).numpy()
        np.testing.assert_array_equal(ranks[0][mode], one)
        want = np.asarray(jax_render_fn(LABELLED_IMG, LABELLED_IMG, 2, mode, mesh=mesh)(*jargs))
        d = np.abs(ranks[0][mode].astype(np.int32) - want.astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (mode, d.max(), (d > 0).mean())
