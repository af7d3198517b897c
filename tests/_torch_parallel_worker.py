"""One rank of the port's parallel tests: imports numpy, torch and the port,
never JAX, and joins its ranks over gloo on the CPU.

Run: python tests/_torch_parallel_worker.py CASE RANK WORLD PORT DIR

``DIR`` holds the case's inputs (``case.json``, ``vars.npz``,
``batches.npz``), written by the test, and takes its outputs
(``rank{r}.npz``, ``out.npz``). Every case runs under a time limit with
``faulthandler`` armed, so a hung rendezvous or collective fails.

Cases:
- ``step``: the train step of ``case.json`` (mode dp / fsdp / tp, the
  mesh, the optimizer) on the rank's rows of each global batch; rank 0
  writes the loss items and the gathered state (flax names), every rank its
  replicated leaves and its split leaves' sizes.
- ``loader``: ``ToyDataset`` through ``DataLoader(shard=(rank, world))``,
  one DP step per batch; each rank writes its items and batch count.
- ``serve``: ``make_sharded_serving_fn`` (float, and int8 when asked),
  gathered to rank 0; an indivisible batch must raise.
- ``render``: ``make_render_fn(mesh=)`` over the global plan batch,
  gathered to rank 0.
- ``repr``: the repr trainer's ``train_step`` on the global view batches;
  rank 0 writes the items and the weights.
- ``preempt``: ``YoloTrainer`` on ``train_files(DIR / "files")`` (written
  by the test); prints EPOCH_DONE per epoch and TRAIN_RETURNED at the end.
- ``latency``: ``make_latency_serving_fn`` over the sub-cases of
  ``case.json`` (model, image size, batch, K1 on or off, ``img_hw`` or not)
  on the images of ``batches.npz``; every rank writes its detections and
  counts, the tallest input of each layer's convs and pools (forward
  pre-hooks), K1's input shapes and the rows it received.
"""

from __future__ import annotations

import faulthandler
import json
import os
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import torch  # noqa: E402

from chip_smoke import local_rows  # noqa: E402

torch.set_num_threads(1)


class ToyDataset:
    """Deterministic synthetic (img, labels, path, shapes) items (the JAX
    tests' ``_multihost_worker.ToyDataset``)."""

    def __init__(self, n: int = 8):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(1000 + i)
        img = rng.integers(0, 255, (64, 64, 3), np.uint8)
        labels = np.array([[i % 6, 0.5, 0.5, 0.25, 0.25]], np.float32)
        return img, labels, f"img{i}", ((64, 64), ((1.0, 1.0), (0.0, 0.0)))


def unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def flatten(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def build_state(case, variables, parallel):
    from ayolov2_torch.loss.yolo_loss import ComputeLoss
    from ayolov2_torch.models import build_model
    from ayolov2_torch.train.optimizer import build_optimizer
    from ayolov2_torch.train.train_state import create_train_state, make_train_step
    from ayolov2_torch.utils.weights import load_flax_variables

    model = load_flax_variables(build_model(case["model_cfg"], device="cpu"), variables)
    loss = ComputeLoss.from_hyp(model.head.stride_anchors(), model.nc, case["hyp"])
    opt = build_optimizer(model, case["hyp"], epochs=3, steps_per_epoch=case["steps_per_epoch"],
                          batch_size=case["batch_size"], accumulate=case["accumulate"])
    state = create_train_state(model, opt)
    return state, make_train_step(loss, image_dtype=torch.float32, parallel=parallel)


def case_step(rank, world, out):
    from ayolov2_torch.parallel.mesh import axis_index, axis_size, get_mesh
    from ayolov2_torch.parallel.sharded import Parallel
    from ayolov2_torch.utils.weights import flax_from_state_dict

    case = json.loads((out / "case.json").read_text())
    variables = unflatten(dict(np.load(out / "vars.npz")))
    batches = np.load(out / "batches.npz")
    shape = tuple(case["mesh"])
    mesh = get_mesh(axis_names=("data", "model")[:len(shape)], shape=shape)
    par = Parallel(mesh, fsdp=case["mode"] == "fsdp", tp=shape[1] if len(shape) > 1 else 1,
                   fsdp_min_elems=case.get("fsdp_min_elems", 65536))
    state, step = build_state(case, variables, par)
    par.setup(state)
    n, i = axis_size(mesh, "data"), axis_index(mesh, "data")
    items = []
    for k in range(case["steps"]):
        images, targets, mask = (batches[f"{key}{k}"] for key in ("images", "targets", "mask"))
        per = images.shape[0] // n
        im, t, m = local_rows(images, targets, mask, i * per, (i + 1) * per)
        items.append(step(state, torch.from_numpy(im), torch.from_numpy(t),
                          torch.from_numpy(m)).numpy())
    full = par.full_state(state)
    mine = {f"rep/{k}": v.detach().numpy() for k, v in state.model.state_dict().items()
            if k not in par.dims and v.is_floating_point()}
    mine.update({f"rep_ema/{k}": v.detach().numpy() for k, v in state.ema_model.state_dict().items()
                 if k not in par.dims and v.is_floating_point()})
    mine.update({f"split/{k}": np.array([state.model.state_dict()[k].numel()])
                 for k in par.dims if k in state.model.state_dict()})
    mine["bytes"] = np.array([par.state_bytes(state)["all"], par.state_bytes(state)["split"]])
    mine["counters"] = np.array([state.step, state.ema_updates, state.optimizer.updates])
    np.savez(out / f"rank{rank}.npz", **mine)
    if rank == 0:
        res = {"items": np.stack(items)}
        res.update({f"model/{k}": v for k, v in
                    flatten(flax_from_state_dict(full.model.state_dict())).items()})
        res.update({f"ema/{k}": v for k, v in
                    flatten(flax_from_state_dict(full.ema_model.state_dict())).items()})
        np.savez(out / "out.npz", **res)


def case_loader(rank, world, out):
    from ayolov2_torch.data.loader import DataLoader
    from ayolov2_torch.parallel.mesh import get_mesh
    from ayolov2_torch.parallel.sharded import Parallel

    case = json.loads((out / "case.json").read_text())
    variables = unflatten(dict(np.load(out / "vars.npz")))
    par = Parallel(get_mesh())
    state, step = build_state(case, variables, par)
    par.setup(state)
    loader = DataLoader(ToyDataset(case["n_items"]), batch_size=case["global_bs"], shuffle=False,
                        shard=(rank, world), max_labels_per_image=4, workers=1)
    items = [step(state, torch.from_numpy(b.images), torch.from_numpy(b.targets),
                  torch.from_numpy(b.target_mask)).numpy() for b in loader]
    np.savez(out / f"rank{rank}.npz", items=np.stack(items), n_batches=np.array([len(items)]))


def case_serve(rank, world, out):
    from ayolov2_torch.compress.quantize import quantize_model
    from ayolov2_torch.models import build_model
    from ayolov2_torch.parallel.mesh import get_mesh
    from ayolov2_torch.parallel.serve import make_sharded_serving_fn
    from ayolov2_torch.utils.weights import load_flax_variables

    case = json.loads((out / "case.json").read_text())
    variables = unflatten(dict(np.load(out / "vars.npz")))
    x = np.load(out / "batches.npz")["images"]
    mesh = get_mesh()
    kw = dict(conf_thres=1e-5, keep_top_k=10, top_k=32, image_dtype=torch.float32,
              img_hw=(64, 64), device="cpu", gather=True)
    res = {}
    model = load_flax_variables(build_model(case["model_cfg"], device="cpu"), variables).fuse()
    serve = make_sharded_serving_fn(mesh, model, **kw)
    res["det"], res["n"] = (t.numpy() for t in serve(x))
    calib = [torch.from_numpy(np.load(out / "batches.npz")["calib"]).permute(0, 3, 1, 2)]
    qmodel, _ = quantize_model(case["model_cfg"], variables, calib, dtype=torch.float32,
                               device="cpu")
    qserve = make_sharded_serving_fn(mesh, qmodel, **kw)
    res["qdet"], res["qn"] = (t.numpy() for t in qserve(x))
    try:
        serve(x[:world * 2 - 1])
        res["indivisible"] = np.array([0])
    except ValueError as e:
        res["indivisible"] = np.array([int("not divisible" in str(e))])
    np.savez(out / f"rank{rank}.npz", **res)


def case_render(rank, world, out):
    from ayolov2_torch.data.device_augment import make_render_fn
    from ayolov2_torch.parallel.collectives import gather
    from ayolov2_torch.parallel.mesh import get_mesh

    case = json.loads((out / "case.json").read_text())
    arrs = {k: torch.from_numpy(v) for k, v in np.load(out / "batches.npz").items()}
    mesh = get_mesh()
    res = {}
    for mode in ("gather", "separable"):
        render = make_render_fn(case["img"], case["frame"], case["pairs"], mode, mesh=mesh)
        mine = render(arrs["frames"], arrs["src_idx"], arrs["rects"], arrs["offs"], arrs["minv"],
                      arrs["blend"], arrs["hsv"], arrs["flips"])
        res[f"{mode}_rows"] = np.array([mine.shape[0]])
        res[mode] = gather(mine, 0).numpy()
    np.savez(out / f"rank{rank}.npz", **res)


def repr_trainer(cfg, rl_type):
    """The repr trainer of ``cfg`` (seed-0 weights) on a loader of nothing:
    the tests call its ``train_step``."""
    from ayolov2_torch.models import build_model, init_model
    from ayolov2_torch.train.repr_trainer import RepresentationLearningTrainer

    model = init_model(build_model(cfg["model_cfg"], device="cpu"), seed=0)
    tcfg = {"train": {"epochs": 1, "batch_size": cfg["bs"], "n_trans": 2},
            "hyper_params": {"optimizer_params": {"lr": 0.01}}}
    return RepresentationLearningTrainer(model, tcfg, [None] * cfg["steps"], rl_type=rl_type,
                                         log_dir=str(cfg["log_dir"]), device="cpu")


def case_repr(rank, world, out):
    from ayolov2_torch.utils.weights import flax_from_state_dict

    case = json.loads((out / "case.json").read_text())
    trainer = repr_trainer(dict(case, log_dir=out / f"r{rank}"), case["rl_type"])
    views = np.load(out / "batches.npz")["views"]
    items = [trainer.train_step(torch.from_numpy(v)).numpy() for v in views]
    if rank == 0:
        np.savez(out / "out.npz", items=np.stack(items),
                 **flatten(flax_from_state_dict(trainer.model.state_dict())))


def case_preempt(rank, world, out):
    from ayolov2_torch.data import DataLoader, DetectionDataset
    from ayolov2_torch.models import build_model
    from ayolov2_torch.train.trainer import YoloTrainer
    from ayolov2_torch.utils.config import load_yaml

    class MarkerTrainer(YoloTrainer):
        def on_epoch_end(self, epoch: int) -> None:
            super().on_epoch_end(epoch)
            print(f"EPOCH_DONE {epoch}", flush=True)

    model_cfg, cfg_path = out / "files" / "model.yaml", out / "files" / "cfg.yaml"
    cfg = load_yaml(cfg_path)
    cfg["train"].update(epochs=100, batch_size=4, patience=10_000, auto_anchor=False,
                        half=False, plot=False)
    loader = DataLoader(DetectionDataset(str(out / "files" / "images"), img_size=64,
                                         batch_size=4), batch_size=4, shuffle=True,
                        drop_last=True, shard=(rank, world), workers=1)
    model = build_model(load_yaml(model_cfg), device="cpu")
    trainer = MarkerTrainer(model, cfg, loader, log_dir=str(out / "run"), device="cpu",
                            n_devices=world)
    trainer.train()
    print(f"TRAIN_RETURNED preempted={trainer.is_preempted} early_stop={trainer.is_early_stop} "
          f"epoch={trainer.current_epoch}", flush=True)


def latency_model(case, kind, variables):
    """A sub-case's model: the JAX weights (``tiny``), their int8 form
    (``int8``, calibrated on ``calib``), or a seeded narrow v5 / MobileViT."""
    from ayolov2_torch.compress.quantize import quantize_model
    from ayolov2_torch.models import build_model, init_model
    from ayolov2_torch.utils.weights import load_flax_variables

    if kind == "tiny":
        return load_flax_variables(build_model(case["model_cfg"], nc=20, device="cpu"),
                                   variables).fuse()
    if kind == "int8":
        calib = torch.from_numpy(np.load(case["dir"] + "/batches.npz")["calib"])
        return quantize_model(case["model_cfg"], variables, [calib.permute(0, 3, 1, 2)],
                              dtype=torch.float32, nc=20, device="cpu")[0]
    return init_model(build_model(case["cfgs"][kind], nc=20, device="cpu"),
                      case["seeds"][kind]).fuse()


def record_rows(model, heights: dict, k1: list):
    """Forward pre-hooks on every conv and pool-holding module of each layer,
    keeping the tallest input by layer, and K1's inputs; returns the undo."""
    from torch import nn

    from ayolov2_torch.models import layers as L
    from ayolov2_torch.ops import early_pipeline as early

    handles = []
    for i, layer in enumerate(model.model):
        for m in layer.modules():
            if isinstance(m, (nn.Conv2d, L.QuantConv, L.SPP, L.SPPF)):
                handles.append(m.register_forward_pre_hook(
                    lambda mod, args, i=i: heights.__setitem__(
                        i, max(heights.get(i, 0), int(args[0].shape[2])))))
    op = early.early_pipeline_op

    def recording(images, *args, **kw):
        k1.append(list(images.shape))
        return op(images, *args, **kw)

    early.early_pipeline_op = recording

    def undo():
        for h in handles:
            h.remove()
        early.early_pipeline_op = op

    return undo


def case_latency(rank, world, out):
    from ayolov2_torch.parallel.mesh import get_mesh
    from ayolov2_torch.parallel.serve import make_latency_serving_fn

    case = json.loads((out / "case.json").read_text())
    case["dir"] = str(out)
    variables = unflatten(dict(np.load(out / "vars.npz")))
    data = np.load(out / "batches.npz")
    mesh = get_mesh()
    res, rows = {}, {}
    for sub in case["subcases"]:
        name = sub["name"]
        model = latency_model(case, sub["model"], variables)
        hw = tuple(sub["hw"])
        serve = make_latency_serving_fn(
            mesh, model, conf_thres=1e-5, keep_top_k=10, top_k=32, image_dtype=torch.float32,
            img_hw=hw if sub["img_hw"] else None, device="cpu", early_pipeline=sub["early"])
        heights, k1 = {}, []
        undo = record_rows(serve.core.model, heights, k1)
        det, n = serve(data[name])
        undo()
        res[f"{name}/det"], res[f"{name}/n"] = det.numpy(), n.numpy()
        rows[name] = {"heights": heights, "k1": k1, "early": bool(serve.core.early),
                      "received": {f"{a},{b}": v for (a, b), v in serve.received.items()}}
    np.savez(out / f"rank{rank}.npz", **res)
    (out / f"rank{rank}.json").write_text(json.dumps(rows))


def main() -> None:
    case, rank, world, port, out = sys.argv[1:6]
    rank, world, out = int(rank), int(world), Path(out)
    faulthandler.dump_traceback_later(float(os.environ.get("AYOLO_TEST_CASE_TIMEOUT_S", "240")),
                                      exit=True)
    os.environ["AYOLO_DIST_TIMEOUT_S"] = "120"
    if world > 1:  # JAX's env contract; one rank joins under torchrun's
        os.environ.update(AYOLO_NUM_PROCS=str(world), AYOLO_PROC_ID=str(rank),
                          AYOLO_COORDINATOR=f"localhost:{port}")
    else:
        os.environ.update(WORLD_SIZE="1", RANK="0", MASTER_ADDR="localhost", MASTER_PORT=port)
    from ayolov2_torch.parallel.mesh import initialize_distributed

    initialize_distributed(device="cpu")
    globals()[f"case_{case}"](rank, world, out)
    import torch.distributed as dist

    dist.destroy_process_group()
    jax = [m for m in sys.modules if m.split(".")[0] in ("jax", "ayolov2_tpu")]
    assert not jax, f"the worker imported {jax[:3]}"


if __name__ == "__main__":
    main()
