"""Spatially split serving, ``make_latency_serving_fn``: one image's rows
over gloo ranks on the CPU (``_torch_parallel_worker.py``'s ``latency``
case), against JAX's ``make_latency_serving_fn`` over the suite's 8 virtual
devices and against the port's ``make_serving_fn`` on one device.

- JAX's bs-1 geometry (``tests/test_latency_serve.py``): its model
  (yolov5s, depth 0.33, width 0.25, nc 20, f32, JAX's ``init_model``
  weights) at 64x64 on 8 ranks, so the /32 level's 2 rows leave six ranks
  none; without K1, as JAX; counts equal and detections to 1e-5;
- 2 and 4 ranks with K1 (its plain version here), bs 1 and 3, with and
  without ``img_hw``, at 64 and 96 (the /32 level's 3 rows split unevenly),
  and on 2 ranks the int8 model, the v5 config (Focus, SPP) and MobileViT
  (whole-map layers), against ``make_serving_fn`` on the whole batch;
- the structure: each rank's conv and pool inputs are no taller than its
  rows of the layer times the stride plus the plan's halo, that halo is no
  wider than the layer's own reach, K1's input no taller than 8 rows + 8
  (t + u), and each rank receives the rows its plan says;
- K1 on a row slab without ranks, C3 depth 1-4: the slab with its halo
  gives the whole image's rows bit for bit, and one /8 row less of halo on
  either side does not;
- a module type the plan does not know raises, naming it.
"""

import functools
import json

import numpy as np
import pytest
import torch
from torch import nn

from _torch_parallel_common import flat, run_ranks
from _torch_port_common import ROOT, to_numpy_tree

torch.set_num_threads(1)

KW = dict(conf_thres=1e-5, keep_top_k=10, top_k=32)
SEEDS = {"v5": 3, "mvit": 4}
# the reach of each layer of the JAX tests' yolov5s (C3 depths 1, 2, 3, 1 in
# the backbone, 1 in the neck), in rows above and below stride x its rows:
# the 6x6/s2/p2 stem 2 and 2, a 3x3/s2 conv 2 above (its slab starts on an
# even row) and none below, C3 one per bottleneck, SPPF 3 x 2, a 1x1 conv,
# UpSample and Concat none
REACH = {0: (2, 2), 1: (2, 0), 2: (1, 1), 3: (2, 0), 4: (2, 2), 5: (2, 0), 6: (3, 3),
         7: (2, 0), 8: (1, 1), 9: (6, 6), 10: (0, 0), 11: (0, 0), 12: (0, 0), 13: (1, 1),
         14: (0, 0), 15: (0, 0), 16: (0, 0), 17: (1, 1), 18: (2, 0), 19: (0, 0), 20: (1, 1),
         21: (2, 0), 22: (0, 0), 23: (1, 1)}


def _cfg(name, **over):
    from ayolov2_torch.models.builder import parse_model_config

    return dict(parse_model_config(str(ROOT / f"res/configs/model/{name}.yaml")), **over)


@pytest.fixture(scope="module")
def tiny():
    """JAX's model and fused variables, and the unfused variables as numpy."""
    import jax
    import jax.numpy as jnp

    from ayolov2_tpu.models import build_model, fuse_params, init_model
    from ayolov2_tpu.models.builder import parse_model_config

    cfg = dict(parse_model_config(str(ROOT / "res/configs/model/yolov5s.yaml")),
               depth_multiple=0.33, width_multiple=0.25)
    model = build_model(cfg, dtype=jnp.float32, nc=20)
    variables = jax.jit(functools.partial(init_model, model, img_size=64))(jax.random.PRNGKey(0))
    fused_model = build_model(cfg, dtype=jnp.float32, fused=True, nc=20)
    return cfg, fused_model, fuse_params(variables), to_numpy_tree(variables)


def _images(sub, seed):
    return np.random.default_rng(seed).integers(0, 255, (sub["bs"], *sub["hw"], 3), np.uint8)


def _write(out, cfg, host, subs):
    out.mkdir(parents=True, exist_ok=True)
    case = {"model_cfg": json.loads(json.dumps(cfg)), "subcases": subs, "seeds": SEEDS,
            "cfgs": {"v5": _cfg("yolov5_v5", width_multiple=0.125),
                     "mvit": _cfg("yolov5_mobilevit", width_multiple=0.25)}}
    (out / "case.json").write_text(json.dumps(case))
    np.savez(out / "vars.npz", **flat(host))
    calib = np.random.default_rng(9).random((2, 64, 64, 3)).astype(np.float32)
    np.savez(out / "batches.npz", calib=calib,
             **{s["name"]: _images(s, i) for i, s in enumerate(subs)})
    return case


def _ranks(out, world):
    return ([dict(np.load(out / f"rank{r}.npz")) for r in range(world)],
            [json.loads((out / f"rank{r}.json").read_text()) for r in range(world)])


def _port_model(case, kind, host):
    from _torch_parallel_worker import latency_model

    return latency_model(dict(case, dir=case["dir"]), kind, host)


def _check_structure(case, host, sub, records, world):
    """Each rank's conv and pool inputs against its plan; K1's input; the
    rows received."""
    from ayolov2_torch.ops.early_pipeline import can_fuse_early_model, slab_halo
    from ayolov2_torch.parallel.spatial import row_plan

    model = _port_model(case, sub["model"], host)
    early_n = (len(model.model[2].m) if sub["early"] and can_fuse_early_model(model)
               else None)
    plan = row_plan(model, tuple(sub["hw"]), world, early_n)
    split_somewhere = False
    for rank, rec in enumerate(records):
        assert rec["early"] == (early_n is not None)
        heights = {int(k): v for k, v in rec["heights"].items()}
        for lr in plan.layers:
            if lr.kind == "head":
                tallest = max(b - a for a, b in plan.level_rows(rank))
                assert heights.get(lr.index, 0) <= tallest
                continue
            if lr.kind != "slab":
                continue
            a, b = plan.maps[lr.index].owned[rank]
            lo, hi = lr.need[rank]
            bound = lr.stride * (b - a) + sum(lr.halo)
            assert heights.get(lr.index, 0) <= min(hi - lo, bound), (sub["name"], rank, lr)
            if b == a:
                assert lr.index not in heights, "a rank with no rows computed the layer"
            full = plan.maps[lr.sources[0]].height
            split_somewhere |= 0 < heights.get(lr.index, 0) < full
            if sub["model"] == "tiny":
                assert all(h <= r for h, r in zip(lr.halo, REACH[lr.index])), lr
        if early_n is not None:
            t, u = slab_halo(early_n)
            a, b = plan.maps[3].owned[rank]
            assert rec["k1"] == ([[sub["bs"], min(sub["hw"][0], 8 * (b + u)) -
                                   max(0, 8 * (a - t)), sub["hw"][1], 3]] if b > a else [])
            assert all(s[1] <= 8 * (b - a) + 8 * (t + u) for s in rec["k1"])
        else:
            assert rec["k1"] == []
        want = {f"{a},{b}": v for (a, b), v in plan.received(rank).items()}
        assert rec["received"] == want, (sub["name"], rank)
    assert split_somewhere or world == 1


def _serve_whole(case, host, sub, x):
    from ayolov2_torch.export import make_serving_fn

    model = _port_model(case, sub["model"], host)
    serve = make_serving_fn(model, image_dtype=torch.float32, fused_decode=sub["img_hw"],
                            early_pipeline=sub["early"], device="cpu", **KW)
    det, n = serve(torch.from_numpy(x))
    return det.numpy(), n.numpy()


def _sub(name, model="tiny", hw=(64, 64), bs=1, early=True, img_hw=True):
    return dict(name=name, model=model, hw=list(hw), bs=bs, early=early, img_hw=img_hw)


def test_eight_ranks_equal_jax_latency_serving(tiny, tmp_path):
    """JAX's bs-1 and small-batch geometry on 8 ranks, without K1 (JAX's
    latency path calls no Pallas), against JAX over 8 virtual devices."""
    import jax
    import jax.numpy as jnp

    from ayolov2_tpu.parallel import get_mesh, make_latency_serving_fn

    cfg, jmodel, fused, host = tiny
    assert len(jax.devices()) == 8
    subs = [_sub("bs1", early=False), _sub("bs3_plain", bs=3, early=False, img_hw=False)]
    case = _write(tmp_path, cfg, host, subs)
    case["dir"] = str(tmp_path)
    run_ranks("latency", 8, tmp_path, timeout=240)
    outs, records = _ranks(tmp_path, 8)
    for i, sub in enumerate(subs):
        x = _images(sub, i)
        serve = make_latency_serving_fn(get_mesh(), jmodel, fused, image_dtype=jnp.float32,
                                        img_hw=(64, 64) if sub["img_hw"] else None, **KW)
        det, n = (np.asarray(t) for t in serve(jnp.asarray(x)))
        assert n.sum() > 0
        for out in outs:
            np.testing.assert_array_equal(out[f"{sub['name']}/n"], n)
            np.testing.assert_allclose(out[f"{sub['name']}/det"], det, atol=1e-5, rtol=1e-5)
        _check_structure(case, host, sub, [r[sub["name"]] for r in records], 8)


TWO = [_sub("k1_64_bs1"), _sub("k1_64_bs3", bs=3, img_hw=False),
       _sub("k1_96_bs1", hw=(96, 96), img_hw=False), _sub("k1_96_bs3", hw=(96, 96), bs=3),
       _sub("plain_96_bs1", hw=(96, 96), early=False),
       _sub("int8", model="int8"), _sub("v5_64", model="v5"),
       _sub("v5_96_bs2", model="v5", hw=(96, 96), bs=2, img_hw=False),
       _sub("mvit", model="mvit")]
FOUR = [_sub("k1_64_bs1"), _sub("k1_96_bs3", hw=(96, 96), bs=3, img_hw=False),
        _sub("plain_64_bs3", bs=3, early=False)]


@pytest.mark.parametrize("world,subs", [(2, TWO), (4, FOUR)], ids=["two", "four"])
def test_ranks_equal_one_device(tiny, tmp_path, world, subs):
    """K1 (plain version) at bs 1 and 3, with and without img_hw, at 64 and
    96; on 2 ranks also int8, v5 (Focus, SPP) and MobileViT: every rank's
    answer equals make_serving_fn's on the whole batch."""
    cfg, _, _, host = tiny
    case = _write(tmp_path, cfg, host, subs)
    case["dir"] = str(tmp_path)
    run_ranks("latency", world, tmp_path, timeout=240)
    outs, records = _ranks(tmp_path, world)
    for i, sub in enumerate(subs):
        det, n = _serve_whole(case, host, sub, _images(sub, i))
        assert n.sum() > 0, sub["name"]
        for out in outs:
            np.testing.assert_array_equal(out[f"{sub['name']}/n"], n, err_msg=sub["name"])
            np.testing.assert_allclose(out[f"{sub['name']}/det"], det, atol=1e-5, rtol=1e-5,
                                       err_msg=sub["name"])
        recs = [r[sub["name"]] for r in records]
        assert all(r["early"] == (sub["early"] and sub["model"] == "tiny") for r in recs)
        _check_structure(case, host, sub, recs, world)


def _k1_params(n: int):
    from ayolov2_torch.models import build_model, init_model
    from ayolov2_torch.ops import early_pipeline as early

    model = init_model(build_model(_cfg("yolov5s", depth_multiple=n / 3, width_multiple=0.125),
                                   device="cpu"), seed=n).fuse()
    assert len(model.model[2].m) == n
    return model, early.extract_early_params(model.state_dict())


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_k1_slab_with_its_halo_is_exact_and_tight(n):
    """K1's plain version on a slab with its halo, cropped, equals the whole
    image's rows bit for bit (top edge, bottom edge, interior, one row,
    none); an interior slab with t - 1 or u - 1 does not. The plan's field
    of layers 0-3 gives the same rows as ``slab_rows``."""
    from ayolov2_torch.ops import early_pipeline as early
    from ayolov2_torch.parallel.spatial import Field, module_field

    model, ep = _k1_params(n)
    images = torch.from_numpy(np.random.default_rng(n).integers(0, 256, (2, 128, 32, 3),
                                                                 np.uint8))
    whole = early.early_pipeline_ref(images, ep)
    wpack = early.pack_weights(ep)
    args = (ep.c0, n, ep.c1, ep.ch, ep.c2)
    t, u = early.slab_halo(n)
    assert (t, u) == (-(-(8 + 4 * n) // 8), -(-(2 + 4 * n) // 8))
    field = Field()
    for i in range(4):
        field = field.then(module_field(model.model[i]))
    for a, b in ((0, 3), (13, 16), (6, 9), (7, 8), (5, 5)):
        got = early.early_pipeline_rows(images, wpack, a, b, *args)
        assert torch.equal(got, whole[:, a:b]), (n, a, b)
        if b > a:
            assert field.rows(a, b, 128)[:2] == early.slab_rows(a, b, 128, n)
    for lo, hi in ((8 * (6 - t + 1), 8 * (9 + u)), (8 * (6 - t), 8 * (9 + u - 1))):
        narrow = early.early_pipeline_ref(images[:, lo:hi].contiguous(), ep)
        assert not torch.equal(narrow[:, 6 - lo // 8:9 - lo // 8], whole[:, 6:9]), (n, lo, hi)


def test_plan_raises_on_an_unknown_module():
    from ayolov2_torch.models import build_model
    from ayolov2_torch.parallel.spatial import row_plan

    class Mystery(nn.Module):
        def forward(self, x):
            return x

    model = build_model(_cfg("yolov5s", depth_multiple=0.33, width_multiple=0.25), nc=20,
                        device="cpu")
    row_plan(model, (64, 64), 2)
    model.model[5] = Mystery()
    with pytest.raises(TypeError, match="Mystery"):
        row_plan(model, (64, 64), 2)
