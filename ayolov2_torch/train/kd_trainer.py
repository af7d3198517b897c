"""The soft-teacher knowledge-distillation trainer.

The counterpart of ``ayolov2_tpu/train/kd_trainer.py`` on one device:

- **Teacher.** A frozen, BN-folded model served by ``make_serving_fn`` in
  bf16 (:func:`make_teacher`): layers 0-3 run as the early-network
  kernel K1 on the raw uint8 pixels whenever
  ``early_pipeline.can_fuse_early_model`` holds (one launch a pseudo
  batch), then the model from ``start_layer=4``; its decoded predictions go
  through ``batched_nms`` (conf 0.4, iou 0.7, nms_box 1000, pre_top_k 256,
  keep_top_k 64, best class only). A detection becomes a pseudo-label when
  its score is above 0.9 and both sides are longer than 20 px; the image
  and its labels then take the strong augmentation
  (``MultiAugmentationPolicies`` of ``strong_augmentation``, drawn from the
  trainer's seeded generator) and the labels are padded to
  ``pad_targets``.
- **Producer thread.** A thread fills a queue of at most 4 pseudo batches
  from the unlabeled loader. An exception raised there reaches
  ``training_step`` and is raised there; a wait for a batch is bounded
  (``PSEUDO_TIMEOUT_S``, 600 s); ``on_train_end`` stops
  the thread and joins it with a bound, which closes the unlabeled loader's
  iterator and so its workers. (The JAX package's producer dies silently on
  an error, and its trainer then waits forever.) K1's library is loaded on
  the main thread before the thread starts. The two threads share the
  device's default stream, so their kernels never overlap anyway; besides,
  every torch call of either thread runs under one lock (the teacher's
  call on the producer's side; the step and its loss sums, the epoch's
  mean, the validation and the checkpoint payloads on the main thread).
  The lock guards a hazard that is not confirmed: a CPU test run stalled
  once with both threads alive and was not reproduced. The producer's
  host work (the cuts, the strong augmentation, the padding) runs beside
  the step.
- **Student step.** In ``train()`` mode the labelled forward, then the
  pseudo forward (BatchNorm's running statistics move twice, in that
  order), one backward of ``loss_l + 0.5 * loss_u`` (each ``ComputeLoss``
  total x bs), the 3-group optimizer's micro-step with accumulation to a
  nominal batch of 64 (``train/optimizer.py``), then the EMA and the
  counters (``train_state.finish_step``).
- **Checkpoints.** ``best.ckpt`` by the validation mAP50 of the EMA model
  (validated on cuDNN, so K1 runs for the teacher alone) and ``last.ckpt``,
  in the JAX package's format (``async_ckpt`` writes them on a thread, as
  ``YoloTrainer``); SIGTERM stops at the next batch and stamps
  ``last.ckpt`` with the previous epoch.

``train.fsdp`` and ``train.tp`` are refused (``refuse_unported``), and so
is more than one device.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from ayolov2_torch.data.augment import MultiAugmentationPolicies
from ayolov2_torch.export import make_serving_fn
from ayolov2_torch.loss.yolo_loss import ComputeLoss, pad_targets
from ayolov2_torch.ops import early_pipeline as early
from ayolov2_torch.ops.nms import detections_to_list
from ayolov2_torch.train.optimizer import NBS_NOMINAL, build_optimizer
from ayolov2_torch.train.train_state import (
    EMA,
    TrainState,
    create_train_state,
    finish_step,
    train_forward,
)
from ayolov2_torch.train.trainer import AbstractTrainer, refuse_unported, scale_hyp_gains
from ayolov2_torch.utils.boxes import xyxy2xywh
from ayolov2_torch.utils.checkpoint import (
    AsyncCheckpointWriter,
    checkpoint_payload,
    write_checkpoint,
)
from ayolov2_torch.utils.general import host_to_device, resolve_device

LOGGER = logging.getLogger(__name__)


class PseudoProducerError(RuntimeError):
    """The pseudo-label thread failed; ``__cause__`` is its exception."""


def make_kd_step(loss_fn: ComputeLoss, w_pseudo: float, ema: EMA = EMA(),
                 image_dtype: torch.dtype = torch.bfloat16):
    """``step(state, imgs_l, tgt_l, mask_l, imgs_u, tgt_u, mask_u) -> (items_l,
    items_u)``: both forwards in train mode (labelled first), one backward of
    ``loss_l + w_pseudo * loss_u``, the optimizer's micro-step, the EMA; the
    state advances in place."""

    def step(state: TrainState, imgs_l, tgt_l, mask_l, imgs_u, tgt_u, mask_u):
        loss_l, items_l = train_forward(state.model, loss_fn, imgs_l, tgt_l, mask_l, image_dtype)
        loss_u, items_u = train_forward(state.model, loss_fn, imgs_u, tgt_u, mask_u, image_dtype)
        (loss_l + w_pseudo * loss_u).backward()
        finish_step(state, ema)
        return items_l.detach(), items_u.detach()

    return step


def make_teacher(model, device, image_dtype: torch.dtype = torch.bfloat16,
                 early_pipeline: bool = True):
    """The pseudo-labeller: ``make_serving_fn`` of the BN-folded ``model``
    with the KD trainer's NMS (conf 0.4, iou 0.7, nms_box 1000, pre_top_k
    256, keep_top_k 64, best class only) in ``image_dtype``, with K1 where
    the model allows it and ``early_pipeline``."""
    return make_serving_fn(
        model, conf_thres=SoftTeacherTrainer.PSEUDO_CONF, iou_thres=SoftTeacherTrainer.PSEUDO_IOU,
        top_k=256, keep_top_k=64, nms_box=1000, image_dtype=image_dtype, fused_decode=False,
        early_pipeline=early_pipeline, multi_label=False, device=device)


class SoftTeacherTrainer(AbstractTrainer):
    """Distil a frozen teacher into a student with pseudo-labels.

    Args:
        student: the port's model being trained (unfused), in place on
            ``device``.
        teacher: the frozen pseudo-labeller, BN folded (``model.fuse()``).
        cfg: the train config (``train``, ``hyper_params``,
            ``strong_augmentation``).
        labeled_loader: a shuffling, drop-last ``DataLoader`` of the
            labelled ``DetectionDataset``.
        unlabeled_loader: a ``DataLoader`` of the unlabeled images
            (detection batches whose labels are not read).
        val_loader: optional; each epoch's validation picks ``best.ckpt``.
        device: default the card (raises without CUDA); "cpu" explicitly.
        early_pipeline: the teacher's layers 0-3 as the early-network
            kernel where ``can_fuse_early_model`` holds (a teacher of a
            width the kernel is not built for raises; pass False to run it
            on cuDNN).

    ``self.teacher`` is :func:`make_teacher`'s serving module (bf16, K1).
    """

    PSEUDO_LOSS_WEIGHT = 0.5
    PSEUDO_CONF = 0.4
    PSEUDO_IOU = 0.7
    PSEUDO_SCORE_THR = 0.9
    PSEUDO_MIN_SIZE = 20.0
    QUEUE_SIZE = 4
    PSEUDO_TIMEOUT_S = 600.0  # the longest wait for a pseudo batch

    def __init__(self, student, teacher, cfg: Dict[str, Any], labeled_loader, unlabeled_loader,
                 val_loader=None, log_dir: str = "runs/distill/exp",
                 model_cfg_dict: Optional[Dict[str, Any]] = None,
                 n_devices: Optional[int] = None, class_names: Optional[list] = None,
                 device=None, early_pipeline: bool = True) -> None:
        tcfg = cfg["train"]
        refuse_unported(tcfg)
        if n_devices is not None and n_devices > 1:
            raise NotImplementedError("training on more than one device is not ported yet; it "
                                      "comes with the parallelism slice of the port")
        super().__init__(epochs=int(tcfg["epochs"]))
        self.device = resolve_device(device)
        self.student = student.to(self.device)
        if self.device.type == "cuda":
            self.student = self.student.to(memory_format=torch.channels_last)
        self.cfg, self.tcfg = cfg, tcfg
        self.labeled_loader = labeled_loader
        self.unlabeled_loader = unlabeled_loader
        self.val_loader = val_loader
        self.log_dir = Path(log_dir)
        self.wdir = self.log_dir / "weights"
        self.wdir.mkdir(parents=True, exist_ok=True)
        self.model_cfg_dict = model_cfg_dict
        self.class_names = class_names or [str(i) for i in range(student.nc)]
        self.max_labels = getattr(labeled_loader, "max_labels", 64)
        self.best_score = 0.0
        self._ckpt_writer = AsyncCheckpointWriter() if tcfg.get("async_ckpt", False) else None

        hyp = dict(cfg["hyper_params"])
        hyp["label_smoothing"] = float(tcfg.get("label_smoothing", 0.0))
        self.hyp = scale_hyp_gains(hyp, student.nl, student.nc, int(tcfg["image_size"]))
        self.loss_fn = ComputeLoss.from_hyp(student.head.stride_anchors(), student.nc, self.hyp)

        self.batch_size = int(tcfg["batch_size"])
        self.accumulate = max(round(NBS_NOMINAL / self.batch_size), 1)
        optimizer = build_optimizer(
            self.student, self.hyp, epochs=self.epochs,
            steps_per_epoch=max(len(labeled_loader), 1), batch_size=self.batch_size,
            accumulate=self.accumulate, optimizer=hyp.get("optimizer", "SGD"),
            linear_lr=bool(tcfg.get("linear_lr", False)))
        self.state: TrainState = create_train_state(self.student, optimizer)
        self.image_dtype = torch.bfloat16 if tcfg.get("half", True) else torch.float32
        self._student_step = make_kd_step(self.loss_fn, self.PSEUDO_LOSS_WEIGHT,
                                          image_dtype=self.image_dtype)

        self.teacher = make_teacher(teacher, self.device, early_pipeline=early_pipeline)
        sa = cfg.get("strong_augmentation")
        self.strong_aug = MultiAugmentationPolicies(sa) if sa else None
        self.rng = np.random.default_rng(int(tcfg.get("seed", 0)))

        self._device_lock = threading.RLock()  # one thread's torch work at a time
        self._pseudo_q: "queue.Queue" = queue.Queue(maxsize=self.QUEUE_SIZE)
        self._stop = threading.Event()
        self._producer: Optional[threading.Thread] = None
        self._producer_error: Optional[BaseException] = None
        self.last_items = np.zeros(4)
        self.pseudo_counts: list = []  # pseudo-labels kept, per pseudo batch
        self.pseudo_launches: list = []  # K1 launches of the teacher, per pseudo batch
        self.pseudo_seconds: list = []  # host seconds to make each pseudo batch
        self.n_steps = 0
        self._loss_sum = torch.zeros(8, device=self.device)
        self.mean_items = np.zeros(8)  # the last epoch's labelled and pseudo loss items
        self.img_per_s = 0.0  # the last epoch's labelled images a second
        self._t_epoch = 0.0

    # -- teacher ----------------------------------------------------------------
    @torch.inference_mode()
    def teacher_detections(self, images: np.ndarray):
        """The teacher's NMS output on a uint8 batch, as per-image (n, 6)
        host arrays [x1, y1, x2, y2, score, class] in pixels."""
        det, n_valid = self.teacher(torch.from_numpy(np.ascontiguousarray(images))
                                    .to(self.device))
        return detections_to_list(det.float().cpu().numpy(), n_valid.cpu().numpy())

    def make_pseudo_batch(self, images: np.ndarray):
        """Teacher NMS -> filter (score, size) -> strong augmentation ->
        (images, targets, mask) on the host."""
        t0 = time.perf_counter()
        with self._device_lock:
            k1_before = early.early_pipeline.launches
            dets = self.teacher_detections(images)
            k1 = early.early_pipeline.launches - k1_before
        h, w = images.shape[1:3]
        out_imgs, labels = [], []
        for i, d in enumerate(dets):
            keep = d[:, 4] > self.PSEUDO_SCORE_THR
            keep &= ((d[:, 2] - d[:, 0] > self.PSEUDO_MIN_SIZE)
                     & (d[:, 3] - d[:, 1] > self.PSEUDO_MIN_SIZE))
            d = d[keep]
            img = images[i]
            lab = np.zeros((len(d), 5), np.float32)
            if len(d):
                lab[:, 0] = d[:, 5]
                lab[:, 1:] = xyxy2xywh(d[:, :4], wh=(w, h), clip_eps=1e-3)
            if self.strong_aug is not None:
                img, lab = self.strong_aug(img.copy(), lab, self.rng)
            out_imgs.append(np.ascontiguousarray(img))
            labels.append(lab)
        targets, mask = pad_targets(labels, len(out_imgs), len(out_imgs) * self.max_labels)
        out = np.stack(out_imgs), targets, mask
        self.pseudo_counts.append(sum(len(lab) for lab in labels))
        self.pseudo_launches.append(k1)
        self.pseudo_seconds.append(time.perf_counter() - t0)
        LOGGER.info("pseudo batch %d: %d pseudo-labels above %.1f (early_pipeline launches %d), "
                    "%.3f s", len(self.pseudo_counts) - 1, self.pseudo_counts[-1],
                    self.PSEUDO_SCORE_THR, k1, self.pseudo_seconds[-1])
        return out

    def _pseudo_producer(self) -> None:
        try:
            while not self._stop.is_set():
                if len(self.unlabeled_loader) == 0:
                    raise ValueError("the unlabeled loader gives no batch (fewer images than "
                                     "one batch?)")
                batches = iter(self.unlabeled_loader)
                try:
                    for batch in batches:
                        if self._stop.is_set():
                            return
                        item = self.make_pseudo_batch(batch.images)
                        while not self._stop.is_set():
                            try:
                                self._pseudo_q.put(item, timeout=0.5)
                                break
                            except queue.Full:
                                continue
                finally:
                    batches.close()  # stops the loader's workers
        except BaseException as e:  # raised again by training_step
            self._producer_error = e

    def _next_pseudo_batch(self):
        deadline = time.monotonic() + self.PSEUDO_TIMEOUT_S
        while True:
            try:
                return self._pseudo_q.get(timeout=0.5)
            except queue.Empty:
                pass
            if self._producer_error is not None:
                raise PseudoProducerError(
                    "the pseudo-label thread failed") from self._producer_error
            if self._producer is None or not self._producer.is_alive():
                raise PseudoProducerError("the pseudo-label thread is not running")
            if time.monotonic() > deadline:
                raise TimeoutError(f"no pseudo batch within {self.PSEUDO_TIMEOUT_S:.0f} s")

    def _start_producer(self) -> None:
        if self.device.type == "cuda" and self.teacher.early:
            early._lib(self.teacher.ep.c0)  # built and loaded once, on this thread
        self._stop.clear()
        self._producer_error = None
        self._producer = threading.Thread(target=self._pseudo_producer, daemon=True,
                                          name="pseudo-labels")
        self._producer.start()

    def _stop_producer(self, timeout: float = 60.0) -> None:
        self._stop.set()
        while True:  # a producer blocked on a full queue sees the flag
            try:
                self._pseudo_q.get_nowait()
            except queue.Empty:
                break
        if self._producer is not None:
            self._producer.join(timeout=timeout)
            if self._producer.is_alive():
                LOGGER.warning("the pseudo-label thread did not stop within %.0f s", timeout)
            self._producer = None

    # -- lifecycle ----------------------------------------------------------------
    def on_train_start(self) -> None:
        LOGGER.info("Start distillation: %d epochs, batch %d (accumulate %d), teacher %s%s, "
                    "device %s", self.epochs, self.batch_size, self.accumulate,
                    str(self.teacher.image_dtype).replace("torch.", ""),
                    " with the early-network kernel" if self.teacher.early else "", self.device)
        self._start_producer()

    def epoch_iterator(self):
        return self.labeled_loader

    def on_epoch_start(self, epoch: int) -> None:
        self.n_steps = 0
        self._loss_sum.zero_()
        self._t_epoch = time.perf_counter()

    def training_step(self, batch, batch_idx: int) -> Dict[str, float]:
        imgs_u, tgt_u, mask_u = self._next_pseudo_batch()
        dev = self.device
        with self._device_lock:
            items_l, items_u = self._student_step(
                self.state, torch.from_numpy(batch.images).to(dev, non_blocking=True),
                host_to_device(batch.targets, dev), host_to_device(batch.target_mask, dev),
                torch.from_numpy(imgs_u).to(dev, non_blocking=True), host_to_device(tgt_u, dev),
                host_to_device(mask_u, dev))
            self._loss_sum += torch.cat([items_l, items_u])
            if batch_idx % 20 == 0:
                self.last_items = items_l.cpu().numpy()
                pseudo_loss = float(items_u[3])
        self.n_steps += 1
        if batch_idx % 20 == 0:
            LOGGER.info("epoch %3d step %4d  labeled %.4f  pseudo %.4f  pseudo-labels %d",
                        self.current_epoch, batch_idx, float(self.last_items[3]), pseudo_loss,
                        self.pseudo_counts[-1] if self.pseudo_counts else 0)
        return {}

    def on_epoch_end(self, epoch: int) -> None:
        dt = time.perf_counter() - self._t_epoch
        with self._device_lock:
            self.mean_items = (self._loss_sum / max(self.n_steps, 1)).cpu().numpy()
        self.img_per_s = self.n_steps * self.batch_size / max(dt, 1e-9)
        LOGGER.info("epoch %3d done in %.1fs (%.1f img/s): %d steps, mean labeled loss %.4f, "
                    "pseudo %.4f", epoch, dt, self.img_per_s, self.n_steps,
                    self.mean_items[3], self.mean_items[7])

    def on_preempt(self) -> None:
        self._save_weights("last.ckpt")

    def validation(self) -> None:
        if self.val_loader is None:
            self._save_weights("last.ckpt")
            return
        from ayolov2_torch.eval import YoloValidator

        with self._device_lock:
            if getattr(self, "_validator", None) is None:
                # cuDNN for the student: K1 is the teacher's alone on this path
                self._validator = YoloValidator(
                    self.state.ema_model, self.val_loader, class_names=self.class_names,
                    cfg={"half": bool(self.tcfg.get("half", True)), "early_pipeline": False},
                    device=self.device)
            else:
                self._validator.update_weights(self.state.ema_model)
            result = self._validator.validation()
        map50 = result["map50"]
        self.log_dict({"mAP50": map50, "mAP50_95": result["map50_95"]})
        LOGGER.info("epoch %3d validation: mAP50 %.5f mAP50-95 %.5f", self.current_epoch, map50,
                    result["map50_95"])
        if map50 >= self.best_score:
            self.best_score = map50
            self._save_weights("best.ckpt", map50=map50)
        self._save_weights("last.ckpt", map50=map50)

    def on_train_end(self) -> None:
        self._stop_producer()
        self._save_weights("last.ckpt")
        if self._ckpt_writer is not None:
            self._ckpt_writer.wait()
        LOGGER.info("Distillation done. best mAP50 = %.4f; weights in %s", self.best_score,
                    self.wdir)

    def train(self) -> None:
        try:
            super().train()
        finally:  # also when a step raised: the thread and the loader stop
            self._stop_producer()

    def _save_weights(self, name: str, map50: Optional[float] = None) -> None:
        epoch = self.current_epoch - 1 if self.partial_epoch else self.current_epoch
        with self._device_lock:
            payload = checkpoint_payload(self.state, epoch, best_score=self.best_score,
                                         map50=map50, model_cfg=self.model_cfg_dict)
        path = self.wdir / name
        if self._ckpt_writer is not None:
            self._ckpt_writer.submit(lambda: write_checkpoint(path, payload))
        else:
            write_checkpoint(path, payload)
