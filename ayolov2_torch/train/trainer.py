"""Trainers: the epoch lifecycle (``AbstractTrainer``) and ``YoloTrainer``.

The counterpart of ``ayolov2_tpu/train/trainer.py``, on one device or on
the ranks of ``torch.distributed`` (see below):

- the loss with its gains rescaled for the model (``scale_hyp_gains``),
  the 3-group optimizer with warmup and accumulation to a nominal batch of
  64, the EMA, and the train step of ``train/train_state.py``; the
  trainer calls ``model.train()`` around each step (BatchNorm on batch
  statistics, flax's update) and validates the EMA copy in ``eval()``;
- auto-anchor on start, image-weighted sampling, multi-scale batches
  (resized by the port's own INTER_LINEAR), ``validate_period``, a second
  validation protocol (``val_loader_aux``, logged as ``mAP50_aux``),
  best / last / ``save_period`` / SWA ``epoch_N.ckpt`` checkpoints in the
  JAX package's format, early stopping on mAP50, resume with a backup of
  the previous run's weights (from a checkpoint of either package: a JAX
  run's optax state is mapped onto the port's optimizer), ``async_ckpt``,
  and SIGTERM preemption: the loop stops at the next batch and
  ``last.ckpt`` is stamped with the previous epoch, so a resume re-runs the
  interrupted one;
- ``device_aug``: the loader yields plans (``PlanBatch``) and
  ``training_step`` renders them on the trainer's device
  (``data/device_augment.py``, operands in ``device_aug_dtype``); the
  rendered batch goes to the step without leaving the device;
- ``plot`` (default true): ``labels.png`` (the class histogram and box
  sizes) at the start and ``train_batch{0,1,2}.png``, the first three
  batches of epoch 0 as the step sees them (the host batch, or the rendered
  one with ``device_aug``), in the run dir; a plot that fails is logged and
  training goes on;
- a ``torch.profiler`` trace of steps 2 to 1 + ``AYOLO_TRACE_STEPS`` under
  ``AYOLO_TRACE_DIR/train`` when that is set (``utils/profiling.py``).

``train.remat`` is the model's (``build_model(remat=...)``, set by
``cli/train.py``): each layer an activation checkpoint, BN statistics moved
once a step.

On N ranks (``torch.distributed`` initialised, ``parallel.mesh.
initialize_distributed``; ``n_devices`` is then the rank count) the step on
the ranks equals the step on the global batch on one device
(``parallel/sharded.py``): ``train.batch_size`` is the global batch, each
rank's loader holds its shard (``DataLoader(shard=...)``, padded so every
rank runs as many batches), ``train.fsdp`` splits the large leaves over the
data axis (``train.fsdp_min_elems``) and ``train.tp`` over a model axis of
that size (a ``("data", "model")`` mesh; tp wins over fsdp, with the JAX
package's warning). Checkpoints, plots, validation and the result writer are
rank 0's, after a gather of the split leaves that every rank joins; a stop
(early stopping, or SIGTERM on any rank) is agreed by an all-reduce MAX at
each validation, so every rank leaves at the same epoch. With device
augmentation each rank renders its own shard's plans.
"""

from __future__ import annotations

import logging
import shutil
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ayolov2_torch.data.device_augment import DeviceAugmenter
from ayolov2_torch.data.image_io import resize_linear
from ayolov2_torch.loss.yolo_loss import ComputeLoss
from ayolov2_torch.models.builder import count_params
from ayolov2_torch.parallel.mesh import (
    broadcast_object,
    get_mesh,
    host_broadcast_max,
    is_main_process,
    world_size,
)
from ayolov2_torch.parallel.sharded import Parallel
from ayolov2_torch.train.optimizer import NBS_NOMINAL, build_optimizer
from ayolov2_torch.train.train_state import TrainState, create_train_state, make_train_step
from ayolov2_torch.utils.anchors import check_anchors
from ayolov2_torch.utils.checkpoint import (
    AsyncCheckpointWriter,
    checkpoint_payload,
    restore_train_state,
    write_checkpoint,
)
from ayolov2_torch.utils.general import (
    check_img_size,
    host_to_device,
    labels_to_class_weights,
    labels_to_image_weights,
    resolve_device,
)
from ayolov2_torch.utils.plots import plot_images, plot_label_histogram
from ayolov2_torch.utils.profiling import StepWindowTracer

LOGGER = logging.getLogger(__name__)


class EarlyStopping:
    """Stop when the score has not improved for ``patience`` epochs."""

    def __init__(self, patience: int = 30) -> None:
        self.best_score = 0.0
        self.best_epoch = 0
        self.patience = patience or float("inf")

    def __call__(self, epoch: int, score: float) -> bool:
        if score >= self.best_score:
            self.best_epoch = epoch
            self.best_score = score
        stop = (epoch - self.best_epoch) >= self.patience
        if stop:
            LOGGER.info("EarlyStopping: no improvement in last %d epochs (best %.4f @ epoch %d)",
                        self.patience, self.best_score, self.best_epoch)
        return stop


def scale_hyp_gains(hyp: Dict[str, Any], nl: int, nc: int, img_size: int) -> Dict[str, Any]:
    """The loss gains rescaled for the model: box x 3/nl, cls x nc/80 x 3/nl,
    obj x (img/640)^2 x 3/nl."""
    out = dict(hyp)
    out["box"] = hyp.get("box", 0.05) * 3.0 / nl
    out["cls"] = hyp.get("cls", 0.5) * nc / 80.0 * 3.0 / nl
    out["obj"] = hyp.get("obj", 1.0) * (img_size / 640.0) ** 2 * 3.0 / nl
    return out


class AbstractTrainer:
    """The epoch loop: on_train_start -> [on_epoch_start -> training_step* ->
    on_epoch_end -> validation] -> on_train_end, with an early-stop break.

    While ``train()`` runs, SIGTERM sets a flag; the loop stops at the next
    batch, calls ``on_preempt`` (a checkpoint) and returns.
    """

    preempt_signals: tuple = ("SIGTERM",)

    def __init__(self, epochs: int, start_epoch: int = 0) -> None:
        self.epochs = epochs
        self.start_epoch = start_epoch
        self.current_epoch = start_epoch
        self.is_early_stop = False
        self.is_preempted = False
        # the interrupted epoch ran only some batches: checkpoints stamp the
        # previous one, so a resume runs it again in full
        self.partial_epoch = False
        self.state_dict: Dict[str, Any] = {}

    def on_train_start(self) -> None: ...
    def on_epoch_start(self, epoch: int) -> None: ...
    def training_step(self, batch, batch_idx: int) -> Dict[str, float]:
        raise NotImplementedError
    def on_epoch_end(self, epoch: int) -> None: ...
    def validation(self) -> None: ...
    def on_train_end(self) -> None: ...
    def on_preempt(self) -> None: ...
    def epoch_iterator(self):
        raise NotImplementedError

    def log_dict(self, metrics: Dict[str, Any]) -> None:
        self.state_dict.update(metrics)

    def _install_preempt_handlers(self):
        """Signal handlers for the duration of ``train()``; returns the
        restore callback. Outside the main thread nothing is installed."""
        import signal

        prev = {}

        def _handler(signum, frame):  # noqa: ARG001
            LOGGER.warning("received %s: checkpointing and stopping at the next batch boundary",
                           signal.Signals(signum).name)
            self.is_preempted = True

        for name in self.preempt_signals:
            sig = getattr(signal, name, None)
            if sig is None:
                continue
            try:
                prev[sig] = signal.signal(sig, _handler)
            except ValueError:  # not in the main thread
                LOGGER.warning("cannot install %s handler outside the main thread", name)

        def _restore() -> None:
            for sig, h in prev.items():
                try:
                    signal.signal(sig, h)
                except ValueError:
                    pass

        return _restore

    def train(self) -> None:
        restore_signals = self._install_preempt_handlers()
        try:
            self._train_loop()
        finally:
            restore_signals()

    def _train_loop(self) -> None:
        # a rank leaving the epoch alone would leave the others waiting in the
        # next collective: on several ranks a preemption stops the run at the
        # validation's consensus, not mid-epoch
        single = world_size() == 1
        self.on_train_start()
        for epoch in range(self.start_epoch, self.epochs):
            self.current_epoch = epoch
            self.on_epoch_start(epoch)
            for i, batch in enumerate(self.epoch_iterator()):
                self.training_step(batch, i)
                if self.is_preempted and single:
                    break
            self.on_epoch_end(epoch)
            if self.is_preempted and single:
                # treated as partial even if the signal came after the last
                # batch: running a finished epoch again is safe, skipping one is not
                self.partial_epoch = True
                self.on_preempt()
                LOGGER.warning("preempted: stopped cleanly at epoch %d", epoch)
                break
            self.validation()
            if self.is_early_stop:
                LOGGER.info("Early stopping at epoch %d", epoch)
                break
        self.on_train_end()


def make_parallel(tcfg: Dict[str, Any], n_devices: Optional[int], allow_tp: bool = True
                  ) -> Optional[Parallel]:
    """The trainers' ranks: None on one process without ``torch.distributed``;
    else the mesh (``("data", "model")`` with ``train.tp``) and its
    ``Parallel``. ``n_devices`` must equal the rank count when given."""
    world = world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(
            f"n_devices={n_devices} but this process is one of {world} rank(s): start "
            f"{n_devices} ranks (cli --n-devices {n_devices}, torchrun, or AYOLO_NUM_PROCS) and "
            "call parallel.initialize_distributed first")
    if not (torch.distributed.is_available() and torch.distributed.is_initialized()):
        return None
    tp = int(tcfg.get("tp", 0) or 0) if allow_tp else 0
    if tp > 1:
        if world % tp:
            raise ValueError(f"train.tp={tp} does not divide {world} ranks")
        mesh = get_mesh(axis_names=("data", "model"), shape=(world // tp, tp))
    else:
        mesh = get_mesh()
    return Parallel(mesh, fsdp=bool(tcfg.get("fsdp", False)), tp=tp,
                    fsdp_min_elems=int(tcfg.get("fsdp_min_elems", 65536)))


class YoloTrainer(AbstractTrainer):
    """The detection trainer, on one device or on this process's rank.

    Args:
        model: a ``YOLOModel`` (unfused) with its initial weights; trained
            in place, on ``device``.
        cfg: the train config (sections ``train`` and ``hyper_params``).
        train_loader: a shuffling, drop-last ``DataLoader`` over the train
            ``DetectionDataset``.
        val_loader: optional loader of the validation each epoch (or every
            ``validate_period`` epochs); ``val_loader_aux`` a second one,
            logged as ``mAP50_aux``.
        log_dir: the run dir; checkpoints go to ``log_dir/weights``.
        model_cfg_dict: the model config stored in the checkpoints.
        n_devices: the rank count (checked against ``torch.distributed``).
        device: default the card (raises without CUDA); "cpu" explicitly;
            on several ranks, the rank's device.
    """

    def __init__(self, model, cfg: Dict[str, Any], train_loader, val_loader=None,
                 log_dir: str = "runs/train/exp", class_names: Optional[List[str]] = None,
                 use_swa: bool = False, n_devices: Optional[int] = None,
                 model_cfg_dict: Optional[Dict[str, Any]] = None, val_loader_aux=None,
                 device=None) -> None:
        tcfg = cfg["train"]
        self.parallel = make_parallel(tcfg, n_devices)
        super().__init__(epochs=int(tcfg["epochs"]))
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        if self.device.type == "cuda":
            self.model = self.model.to(memory_format=torch.channels_last)
        self.cfg = cfg
        self.tcfg = tcfg
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.val_loader_aux = val_loader_aux
        self.log_dir = Path(log_dir)
        self.wdir = self.log_dir / "weights"
        self.wdir.mkdir(parents=True, exist_ok=True)
        self.class_names = class_names or [str(i) for i in range(model.nc)]
        self.use_swa = use_swa
        self.model_cfg_dict = model_cfg_dict
        self.best_score = 0.0
        self.val_maps = np.zeros(model.nc)
        self.stopper = EarlyStopping(int(tcfg.get("patience", 30)))

        self.gs = int(max(model.strides))
        self.img_size = check_img_size(int(tcfg["image_size"]), self.gs)
        self.batch_size = int(tcfg["batch_size"])
        self.multi_scale = bool(tcfg.get("multi_scale", False))
        self.image_dtype = torch.bfloat16 if tcfg.get("half", True) else torch.float32

        hyp = dict(cfg["hyper_params"])
        hyp["label_smoothing"] = float(tcfg.get("label_smoothing", 0.0))
        self.hyp = scale_hyp_gains(hyp, model.nl, model.nc, self.img_size)
        self.compute_loss = ComputeLoss.from_hyp(model.head.stride_anchors(), model.nc, self.hyp)

        self.accumulate = max(round(NBS_NOMINAL / self.batch_size), 1)
        optimizer = build_optimizer(
            self.model, self.hyp, epochs=self.epochs,
            steps_per_epoch=max(len(train_loader), 1), batch_size=self.batch_size,
            accumulate=self.accumulate, optimizer=hyp.get("optimizer", "SGD"),
            linear_lr=bool(tcfg.get("linear_lr", False)), freeze=int(tcfg.get("freeze", 0)))
        self.state: TrainState = create_train_state(self.model, optimizer)
        self._train_step = make_train_step(self.compute_loss, image_dtype=self.image_dtype,
                                           parallel=self.parallel)
        self._ckpt_state = None  # the gathered state of a validation or the end

        self.mloss = np.zeros(4)
        self.n_steps = 0
        self._loss_sum = torch.zeros(4, device=self.device)
        self._t_epoch = 0.0
        self._validator = self._validator_aux = None
        self._ckpt_writer = AsyncCheckpointWriter() if tcfg.get("async_ckpt", False) else None
        self._augmenter = None
        self.plot = bool(tcfg.get("plot", True))
        self._tracer = StepWindowTracer("train", self.device)
        self._step_calls = 0

        self.image_weights = bool(tcfg.get("image_weights", False))
        self.class_weights = labels_to_class_weights(train_loader.dataset.labels, model.nc)

    def resume(self, ckpt_path: str) -> None:
        """Epoch, step, weights, EMA and optimizer from a checkpoint; the
        previous run's weight dir is copied into this run as
        ``backup_epoch_{N}`` (by rank 0). Every rank reads the file before
        its leaves are split (at the start of training)."""
        if self.parallel is not None and self.parallel.ready:
            raise RuntimeError("resume before train(): the state is already split over the ranks")
        _, meta = restore_train_state(ckpt_path, self.state)
        self.start_epoch = int(meta["epoch"]) + 1
        self.best_score = float(meta["best_score"])
        prev_dir = Path(ckpt_path).parent
        if prev_dir.resolve() != self.wdir.resolve() and is_main_process():
            backup = self.log_dir / f"backup_epoch_{self.start_epoch}"
            try:
                shutil.copytree(prev_dir, backup, dirs_exist_ok=True)
                LOGGER.info("backed up previous run dir to %s", backup)
            except OSError as e:
                LOGGER.warning("resume backup failed: %s", e)
        LOGGER.info("Resumed from %s at epoch %d (best %.4f)", ckpt_path, self.start_epoch,
                    self.best_score)

    # -- hooks -----------------------------------------------------------------
    def _setup_parallel(self) -> None:
        """Equal replicas, then the split leaves and the hooks (once)."""
        if self.parallel is not None and not self.parallel.ready:
            self.parallel.setup(self.state)

    def on_train_start(self) -> None:
        if self.tcfg.get("auto_anchor", True):
            anchors, changed = None, False
            if is_main_process():  # one decision, rank 0's, for every rank
                anchors, changed = check_anchors(
                    self.train_loader.dataset,
                    np.asarray(self.model.anchors, np.float32).reshape(self.model.nl, -1, 2),
                    self.model.strides, thr=float(self.hyp.get("anchor_t", 4.0)),
                    img_size=self.img_size)
            anchors, changed = broadcast_object((anchors, changed))
            if changed:
                # the model, its EMA copy, the loss and the stored config
                # all take the new anchors
                self.model.replace_anchors(anchors)
                self.state.ema_model.replace_anchors(anchors)
                self.compute_loss = ComputeLoss.from_hyp(self.model.head.stride_anchors(),
                                                         self.model.nc, self.hyp)
                if isinstance(self.model_cfg_dict, dict):
                    self.model_cfg_dict = dict(self.model_cfg_dict)
                    self.model_cfg_dict["anchors"] = [
                        [float(v) for v in level.reshape(-1)] for level in anchors]
                self._train_step = make_train_step(self.compute_loss,
                                                   image_dtype=self.image_dtype,
                                                   parallel=self.parallel)
        n_params = count_params(self.model)
        self._setup_parallel()
        if self.plot:
            self._plot("labels.png", lambda path: plot_label_histogram(
                self.train_loader.dataset.labels, self.model.nc, path))
        LOGGER.info("Start training: %s params, %d epochs, batch %d (accumulate %d), img %d, "
                    "device %s, %d rank(s)%s", f"{n_params:,}", self.epochs, self.batch_size,
                    self.accumulate, self.img_size, self.device, world_size(),
                    f" ({self.parallel.mode})" if self.parallel is not None else "")
        LOGGER.info("training images: %s", self.augmentation_path())
        if self.plot:
            LOGGER.info("plots: labels.png and train_batch0-2.png in %s", self.log_dir)
        if self._tracer.target:
            LOGGER.info("trace window: steps %d-%d into %s", StepWindowTracer.START_STEP,
                        StepWindowTracer.START_STEP + self._tracer.steps - 1, self._tracer.target)

    def augmentation_path(self) -> str:
        """Where the training images are made: on the card, or on the host by
        the loader's threads or processes."""
        loader = self.train_loader
        if getattr(loader.dataset, "device_aug", False):
            return f"augmented on the card (device_aug; {loader.workers} host threads plan)"
        ds = loader.dataset
        augments = ds.augment or ds.yolo_augmentation.get("mosaic") or ds.policies is not None
        what = "augmented" if augments else "letterboxed"
        mode = getattr(loader, "workers_mode", "thread")
        return f"{what} on the host by {loader.workers} worker " \
               f"{'processes' if mode == 'process' else 'threads'}"

    def epoch_iterator(self):
        return self.train_loader

    def on_epoch_start(self, epoch: int) -> None:
        self.mloss = np.zeros(4)
        self.n_steps = 0
        self._loss_sum.zero_()
        self._t_epoch = time.perf_counter()
        if self.image_weights:
            cw = self.class_weights * (1 - self.val_maps) ** 2
            self.train_loader.sample_weights = labels_to_image_weights(
                self.train_loader.dataset.labels, self.model.nc, cw)

    def _render_batch(self, batch) -> torch.Tensor:
        """Device augmentation: the ``PlanBatch`` rendered into the uint8
        training images on the trainer's device; resident source frames
        move there once, with the first batch."""
        if self._augmenter is None:
            ds = self.train_loader.dataset
            self._augmenter = DeviceAugmenter(
                img_size=self.img_size, frame_size=ds.img_size, pairs=int(batch.minv.shape[1]),
                resident_frames=ds.resident_frames if ds.device_aug_resident else None,
                dtype=str(self.tcfg.get("device_aug_dtype", "bfloat16")), device=self.device)
        return self._augmenter(batch)

    def _plot(self, name: str, draw) -> None:
        """``draw(path)`` into the run dir, timed in the log (rank 0); a plot
        that fails is logged and training goes on."""
        if not is_main_process():
            return
        t0 = time.perf_counter()
        try:
            draw(self.log_dir / name)
        except Exception as e:  # plotting must never stop training
            LOGGER.warning("plot %s failed: %s", name, e)
            return
        LOGGER.info("plot %s written in %.3f s", name, time.perf_counter() - t0)

    def training_step(self, batch, batch_idx: int) -> Dict[str, float]:
        dev = self.device
        self._setup_parallel()
        if batch.images is None and hasattr(batch, "minv"):
            if self.multi_scale:
                raise ValueError("train.device_aug and train.multi_scale are mutually exclusive")
            images = self._render_batch(batch)  # already on the device
        else:
            images = batch.images
        if self.current_epoch == 0 and batch_idx < 3 and self.plot:
            self._plot(f"train_batch{batch_idx}.png", lambda path: plot_images(
                images.cpu().numpy() if torch.is_tensor(images) else images, batch.targets,
                batch.target_mask, path, self.class_names))
        if not torch.is_tensor(images):
            if self.multi_scale:
                images = self._random_resize(images, batch_idx)
            images = torch.from_numpy(images).to(dev, non_blocking=True)
        self._tracer.step(self._step_calls)
        self._step_calls += 1
        items = self._train_step(self.state, images, host_to_device(batch.targets, dev),
                                 host_to_device(batch.target_mask, dev))
        self._loss_sum += items
        self.n_steps += 1
        if batch_idx % 50 == 0:  # sync only on logging steps
            self.mloss = items.cpu().numpy()
            LOGGER.info("epoch %3d step %5d  box %.4f  obj %.4f  cls %.4f  total %.4f",
                        self.current_epoch, batch_idx, *self.mloss)
            return {"loss": float(self.mloss[3])}
        return {}

    def _random_resize(self, images: np.ndarray, batch_idx: int) -> np.ndarray:
        """Multi-scale: the batch resized to a random stride multiple in
        [0.5, 1.5) x img_size (INTER_LINEAR)."""
        rng = np.random.default_rng(self.current_epoch * 100003 + batch_idx)
        sz = int(rng.integers(self.img_size // 2, self.img_size * 3 // 2) // self.gs * self.gs)
        if sz == images.shape[1]:
            return images
        return np.stack([resize_linear(im, (sz, sz)) for im in images])

    def on_epoch_end(self, epoch: int) -> None:
        dt = time.perf_counter() - self._t_epoch
        n = max(self.n_steps, 1)
        mean = (self._loss_sum / n).cpu().numpy()
        LOGGER.info("epoch %3d done in %.1fs (%.1f img/s): %d steps, mean loss box %.4f obj %.4f "
                    "cls %.4f total %.4f", epoch, dt, n * self.batch_size / max(dt, 1e-9),
                    self.n_steps, *mean)

    def on_preempt(self) -> None:
        # the interrupted epoch ran only some batches: stamp the previous one
        # (one rank: several ranks stop at the validation's consensus)
        if is_main_process():
            self._save_weights(self.current_epoch - 1, "last.ckpt")

    def _make_validator(self, ema, loader):
        from ayolov2_torch.eval import YoloValidator

        return YoloValidator(
            ema, loader, class_names=self.class_names,
            cfg={"half": bool(self.tcfg.get("half", True)),
                 "single_cls": bool(self.tcfg.get("single_cls", False))},
            compute_loss=self.compute_loss, device=self.device)

    def _full_state(self) -> TrainState:
        """The state in the one-device layout: gathered (by every rank) when
        leaves are split."""
        if self._ckpt_state is not None:
            return self._ckpt_state
        return self.state if self.parallel is None else self.parallel.full_state(self.state)

    def _validate(self, which: str, loader):
        """One validator a loader for the run; each epoch it takes the EMA
        weights anew."""
        v = getattr(self, which)
        ema = self._full_state().ema_model
        if v is None:
            v = self._make_validator(ema, loader)
            setattr(self, which, v)
        else:
            v.update_weights(ema)
        return v.validation()

    def validation(self) -> None:
        if world_size() == 1:
            self._validation_main()
            return
        # every rank joins the gather of a split state before rank 0 alone
        # validates and saves; then the stop (early stopping on rank 0, a
        # preemption on any rank) is agreed by an all-reduce MAX
        self._ckpt_state = self._full_state()
        try:
            if not is_main_process():
                if host_broadcast_max(self.parallel.mesh, float(self.is_preempted)) > 0:
                    self.is_early_stop = True
            else:
                self._validation_main()
                stop = self.is_early_stop or self.is_preempted
                if host_broadcast_max(self.parallel.mesh, float(stop)) > 0:
                    self.is_early_stop = True
            if self.image_weights:  # rank 0's per-class mAPs weigh every rank's sampling
                self.val_maps = broadcast_object(self.val_maps)
        finally:
            self._ckpt_state = None

    def _validation_main(self) -> None:
        if self.val_loader is None:
            self._save_weights(self.current_epoch, "last.ckpt")
            return
        period = int(self.tcfg.get("validate_period", 1))
        if period > 1 and (self.current_epoch + 1) % period and self.current_epoch != self.epochs - 1:
            self._save_weights(self.current_epoch, "last.ckpt")
            return
        result = self._validate("_validator", self.val_loader)
        self.val_maps = result["maps"]
        if self.val_loader_aux is not None:
            aux = self._validate("_validator_aux", self.val_loader_aux)
            self.log_dict({"mAP50_aux": aux["map50"], "mAP50_95_aux": aux["map50_95"]})
            LOGGER.info("aux val protocol (train-geometry): mAP50 %.4f mAP50:95 %.4f "
                        "(primary rect-protocol mAP50 %.4f)", aux["map50"], aux["map50_95"],
                        result["map50"])
        self.log_dict({
            "mP": result["mp"], "mR": result["mr"],
            "mAP50": result["map50"], "mAP50_95": result["map50_95"],
            "mAP50_95_by_cls": {self.class_names[i]: float(v)
                                for i, v in enumerate(result["maps"]) if i < len(self.class_names)},
        })
        map50 = result["map50"]
        LOGGER.info("epoch %3d validation: mAP50 %.5f mAP50-95 %.5f P %.5f R %.5f, val loss box "
                    "%.4f obj %.4f cls %.4f", self.current_epoch, map50, result["map50_95"],
                    result["mp"], result["mr"], *result["loss"])
        if map50 >= self.best_score:
            self.best_score = map50
            self._save_weights(self.current_epoch, "best.ckpt", map50=map50)
        self._save_weights(self.current_epoch, "last.ckpt", map50=map50)
        if self.use_swa:
            self._save_weights(self.current_epoch, f"epoch_{self.current_epoch}.ckpt", map50=map50)
        save_period = int(self.tcfg.get("save_period", -1))
        if save_period > 0 and self.current_epoch % save_period == 0:
            self._save_weights(self.current_epoch, f"epoch_{self.current_epoch}.ckpt", map50=map50)
        if self.stopper(epoch=self.current_epoch, score=map50):
            self.is_early_stop = True

    def _save_weights(self, epoch: int, name: str, map50: Optional[float] = None) -> None:
        # the state is copied to the host here (in the one-device layout);
        # with async_ckpt the encoding and the write run on the writer's thread
        payload = checkpoint_payload(self._full_state(), epoch, best_score=self.best_score,
                                     map50=map50, model_cfg=self.model_cfg_dict)
        path = self.wdir / name
        if self._ckpt_writer is not None:
            self._ckpt_writer.submit(lambda: write_checkpoint(path, payload))
        else:
            write_checkpoint(path, payload)

    def on_train_end(self) -> None:
        self._tracer.close()
        epoch = self.current_epoch - 1 if self.partial_epoch else self.current_epoch
        self._ckpt_state = self._full_state() if world_size() > 1 else None  # every rank
        try:
            if is_main_process():
                self._save_weights(epoch, "last.ckpt")
        finally:
            self._ckpt_state = None
        if self._ckpt_writer is not None:
            self._ckpt_writer.wait()  # every write is on disk before train() returns
        LOGGER.info("Training done. best mAP50 = %.4f; weights in %s", self.best_score, self.wdir)
