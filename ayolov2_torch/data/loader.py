"""Batching loader: fixed-shape numpy batches built by worker threads or
processes.

The counterpart of ``ayolov2_tpu/data/loader.py``:

- images: (B, H, W, 3) uint8 NHWC (the division by 255 happens on the card);
- labels: (B * max_labels, 6) [img, cls, x, y, w, h] rows + a valid mask;
- ``shard=(index, count)``: each host iterates its slice, the order padded
  by wrapping so every host yields as many batches;
- a short final batch is padded by repeating its first item, and ``n_real``
  says how many items are real, so the validator and the result writer
  count none twice; ``drop_last`` (training) drops it instead;
- ``shuffle``: each epoch's order is ``default_rng(seed + epoch)``'s
  permutation, or with ``sample_weights`` its weighted draw with
  replacement (image weights); the ``epoch`` counter advances after each
  pass and is published to the dataset, and each item gets its position in
  the epoch as a salt (``get_item``). The orders equal the JAX loader's.

``workers`` build batches concurrently, at most ``2 * workers`` ahead of
the consumer, and batches come out in order. ``workers_mode="thread"``
(the default) runs them as threads: enough where numpy releases the GIL, as
in the plan mode and the letterbox. ``"process"`` forks a pool of workers
each epoch (the dataset and its image cache shared copy-on-write), whose
batches cross a pipe; host augmentation holds the GIL for much of each
item, so it scales with processes. A worker's exception is raised again in
the consumer. The workers run numpy only: they touch neither the card nor
torch's thread pools. A dataset in plan mode (``enable_device_aug``) yields
plans, collated into ``PlanBatch``es for the card's renderer, on threads in
either mode.
"""

from __future__ import annotations

import multiprocessing as mp
import pickle
import queue
import threading
import time
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ayolov2_torch.data.device_augment import collate_plans
from ayolov2_torch.loss.yolo_loss import pad_targets


class Batch:
    """One collated batch. ``n_real``: items before final-batch padding."""

    __slots__ = ("images", "targets", "target_mask", "paths", "shapes", "n_labels", "n_real")

    def __init__(self, images, targets, target_mask, paths, shapes, n_labels, n_real=None):
        self.images = images
        self.targets = targets
        self.target_mask = target_mask
        self.paths = paths
        self.shapes = shapes
        self.n_labels = n_labels
        self.n_real = len(paths) if n_real is None else n_real


def collate(items: Sequence, max_labels_per_image: int = 64, n_real: Optional[int] = None) -> Batch:
    """Stack dataset items into one fixed-shape batch."""
    imgs, labels, paths, shapes = zip(*items)
    images = np.stack(imgs)
    bs = len(items)
    targets, mask = pad_targets(labels, bs, bs * max_labels_per_image)
    n_labels = [len(lab) for lab in labels]
    return Batch(images, targets, mask, list(paths), list(shapes), n_labels, n_real)


class DataLoader:
    """Prefetching batch iterator over an indexable dataset.

    Args:
        dataset: ``DetectionDataset`` (items (img, labels, path, shapes)), or
            ``ImageFolderDataset`` (items (img, orig, ratio_pad)) with
            ``detection=False``.
        batch_size: the global batch; with ``shard=(i, n)`` this loader
            yields ``batch_size // n`` items a step from its slice.
        workers: batches built concurrently.
        workers_mode: "thread" or "process" (a forked pool each epoch).
        max_labels_per_image: label rows per image in ``pad_targets``.
        pad_final_batch: pad a short final batch (``n_real`` counts the real
            items).
        shuffle, drop_last, seed: the training order (see above).
        timeout: seconds the consumer waits for the next batch from the
            process pool while a worker is alive, as in torch's
            ``DataLoader``; then the workers are terminated and a
            ``RuntimeError`` names them. 0 waits without a bound.

    Yields ``Batch`` (detection=True) or (images, metas, indices, n_real)
    with metas and indices cut to the real items (detection=False).
    """

    def __init__(
        self,
        dataset,
        batch_size: int = 16,
        workers: int = 2,
        max_labels_per_image: int = 64,
        shard: Tuple[int, int] = (0, 1),
        detection: bool = True,
        pad_final_batch: bool = True,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
        workers_mode: str = "thread",
        timeout: float = 600.0,
    ) -> None:
        if workers_mode not in ("thread", "process"):
            raise ValueError(f"workers_mode must be 'thread' or 'process', got {workers_mode!r}")
        if timeout < 0:
            raise ValueError(f"timeout must be non-negative, got {timeout}")
        self.timeout = timeout
        self.workers_mode = workers_mode
        self.dataset = dataset
        self.shard = shard
        self.batch_size = batch_size // shard[1]
        if self.batch_size < 1:
            raise ValueError(f"batch_size {batch_size} is smaller than the host count {shard[1]}")
        self.workers = max(1, workers)
        self.max_labels = max_labels_per_image
        self.detection = detection
        self.pad_final_batch = pad_final_batch
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.sample_weights: Optional[np.ndarray] = None  # image-weighted resampling

    def __len__(self) -> int:
        n = len(self._host_indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _host_indices(self) -> np.ndarray:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            if self.sample_weights is not None:
                p = self.sample_weights / self.sample_weights.sum()
                order = rng.choice(n, size=n, replace=True, p=p)
            else:
                order = rng.permutation(n)
        idx, cnt = self.shard
        if cnt > 1 and len(order):
            # every host gets ceil(n / cnt) items (the order wraps), so all
            # hosts run the same number of steps
            per = -(-len(order) // cnt)
            total = per * cnt
            if total > len(order):
                order = np.concatenate([order, order[: total - len(order)]])
        return order[idx::cnt]

    def _build(self, b: np.ndarray, n_real: int, pos0: int = 0):
        get = getattr(self.dataset, "get_item", None)
        if get is not None:
            # the item's position in the epoch (unique across hosts) salts it
            items = [get(int(i), pos0 + self.shard[1] * j) for j, i in enumerate(b)]
        else:
            items = [self.dataset[int(i)] for i in b]
        if self.detection:
            if getattr(self.dataset, "device_aug", False):  # plan mode
                return collate_plans(items, len(b), self.max_labels, n_real=n_real)
            return collate(items, self.max_labels, n_real=n_real)
        imgs = np.stack([it[0] for it in items])
        metas = [(it[1], it[2]) for it in items[:n_real]]
        return (imgs, metas, [int(i) for i in b[:n_real]], n_real)

    def __iter__(self) -> Iterator:
        indices = self._host_indices()
        if hasattr(self.dataset, "epoch"):
            self.dataset.epoch = self.epoch
        batches: List[np.ndarray] = [
            indices[i: i + self.batch_size] for i in range(0, len(indices), self.batch_size)
        ]
        n_real: List[int] = [len(b) for b in batches]
        if batches and len(batches[-1]) < self.batch_size:
            if self.drop_last:
                batches.pop()
                n_real.pop()
            elif self.pad_final_batch:
                short = self.batch_size - len(batches[-1])
                batches[-1] = np.concatenate([batches[-1], batches[-1][:1].repeat(short)])
        if self.workers_mode == "process" and not getattr(self.dataset, "device_aug", False):
            yield from self._iter_processes(batches, n_real)
        else:
            yield from self._iter_threads(batches, n_real)
        self.epoch += 1

    def _pos0(self, i: int) -> int:
        sidx, scnt = self.shard
        return sidx + scnt * (i * self.batch_size)

    def _iter_threads(self, batches: List[np.ndarray], n_real: List[int]) -> Iterator:
        n_batches = len(batches)
        results: dict = {}
        errors: List[BaseException] = []
        cond = threading.Condition()
        stop = threading.Event()
        next_task = [0]
        max_ahead = 2 * self.workers  # bounds the memory of built batches

        def worker():
            while not stop.is_set():
                with cond:
                    while not stop.is_set():
                        i = next_task[0]
                        if i >= n_batches:
                            return
                        if len(results) < max_ahead or not results:
                            next_task[0] = i + 1
                            break
                        cond.wait(0.1)
                    else:
                        return
                try:
                    built = self._build(batches[i], n_real[i], self._pos0(i))
                except Exception as e:  # raised again in the consumer
                    with cond:
                        errors.append(e)
                        stop.set()
                        cond.notify_all()
                    return
                with cond:
                    results[i] = built
                    cond.notify_all()

        threads = [
            threading.Thread(target=worker, daemon=True, name=f"loader-w{k}")
            for k in range(min(self.workers, max(n_batches, 1)))
        ]
        for t in threads:
            t.start()
        try:
            for i in range(n_batches):
                with cond:
                    while i not in results and not errors:
                        cond.wait(0.1)
                    if errors:
                        raise errors[0]
                    item = results.pop(i)
                    cond.notify_all()
                yield item
        finally:
            stop.set()
            with cond:
                cond.notify_all()
            for t in threads:
                t.join(timeout=60)

    def _iter_processes(self, batches: List[np.ndarray], n_real: List[int]) -> Iterator:
        """One epoch on a forked pool: the workers take batch numbers from a
        queue and put back (number, batch), at most ``2 * workers`` ahead;
        the consumer reassembles them in order. A worker that died, or no
        batch within ``timeout`` seconds, raises."""
        n_batches = len(batches)
        if n_batches == 0:
            return
        ctx = mp.get_context("fork")
        tasks, results = ctx.Queue(), ctx.Queue()

        def work() -> None:
            import torch

            torch.set_num_threads(1)  # the parent's pools do not survive the fork
            while True:
                i = tasks.get()
                if i is None:
                    return
                try:
                    results.put((i, self._build(batches[i], n_real[i], self._pos0(i))))
                except BaseException as e:  # raised again in the consumer
                    results.put((i, _WorkerError(e)))
                    raise

        procs = [ctx.Process(target=work, daemon=True, name=f"loader-p{k}")
                 for k in range(min(self.workers, n_batches))]
        for p in procs:
            p.start()
        try:
            issued = min(2 * self.workers, n_batches)
            for i in range(issued):
                tasks.put(i)
            done: dict = {}
            poll = min(5.0, self.timeout or 5.0)
            for i in range(n_batches):
                since = time.monotonic()
                while i not in done:
                    try:
                        j, built = results.get(timeout=poll)
                    except queue.Empty:
                        # a worker killed from outside sends nothing
                        dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                        if dead:
                            raise RuntimeError(f"a loader worker died (exit code {dead[0]})")
                        waited = time.monotonic() - since
                        if self.timeout and waited >= self.timeout:
                            pids = [p.pid for p in procs if p.is_alive()]
                            for p in procs:
                                p.terminate()
                            raise RuntimeError(
                                f"no batch from the loader's workers (pids {pids}) in "
                                f"{waited:.1f} s; waited for batch {i} of {n_batches}")
                        continue
                    if isinstance(built, _WorkerError):
                        raise built.error
                    done[j] = built
                if issued < n_batches:
                    tasks.put(issued)
                    issued += 1
                yield done.pop(i)
        finally:
            for _ in procs:
                tasks.put(None)
            for p in procs:
                p.join(timeout=5)
                if p.is_alive():
                    p.terminate()
                    p.join()


class _WorkerError:
    """A worker's exception on its way through the result pipe (as itself
    where it pickles, else as a ``RuntimeError`` with its repr)."""

    def __init__(self, error: BaseException) -> None:
        try:
            pickle.dumps(error)
            self.error = error
        except Exception:
            self.error = RuntimeError(repr(error))
