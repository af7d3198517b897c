"""Checkpoints in the JAX package's format, without flax or msgpack.

The counterpart of ``ayolov2_tpu/utils/checkpoint.py``. A checkpoint is one
msgpack document as ``flax.serialization.msgpack_serialize`` writes it:
nested maps with string keys, ``meta`` scalars, and every array as msgpack
extension type 1 holding a packed ``(shape, dtype name, bytes)``
(``flax.serialization._ndarray_to_bytes``). A small decoder and encoder of
the port's own read and write that, so the card's machine needs neither
package. ``bfloat16`` arrays (the half-precision storage of
:func:`save_checkpoint`) come back as float32, exactly: a bf16 value is the
high 16 bits of the f32 one.

:func:`save_checkpoint` writes the JAX package's layout: ``meta`` (version,
epoch, best_score, map50, model_cfg as JSON, ema_updates, step), and
``model`` / ``ema`` as ``{params, batch_stats}`` trees under the flax names
(params in bf16 when ``half``), so the JAX package's ``load_variables``
reads it. A decomposed model's map is ``meta["decompose_map"]`` (JSON of
{JAX module path: [rank_in, rank_out]}), as the JAX package writes and
reads it; :func:`load_model` rebuilds the decomposed graph from it. The
``optimizer`` section is the port's own layout (keyed by the port's
parameter names). :func:`restore_train_state` resumes from it and from a
JAX run's optax state (``optax.MultiSteps`` over ``multi_transform`` of the
three groups, SGD momentum or Adam), mapped onto the port's optimizer.

``.pt`` paths are the reference's torch checkpoints: :func:`load_variables`
maps them into a template built from the model config it is given
(``utils/torch_import.py``), as the JAX package's ``load_torch_variables``.

Not read: flax's chunked form of arrays above 1 GiB and any other extension
type (both raise).
"""

from __future__ import annotations

import json
import logging
import os
import queue
import struct
import threading
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

CKPT_VERSION = 1
_EXT_NDARRAY = 1
LOGGER = logging.getLogger(__name__)


class _Decoder:
    """msgpack -> Python: maps, arrays (as lists), str, bin (as bytes),
    ints, floats, bool, nil, and extension type 1 as numpy arrays."""

    def __init__(self, data: bytes, path: str) -> None:
        self.buf = memoryview(data)
        self.pos = 0
        self.path = path

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError(f"{self.path}: truncated msgpack data at byte {self.pos}")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self._take(size))[0]

    def decode(self) -> Any:
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.decode() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self._take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self._unpack(ints[b])
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                   0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H",
                   0xC9: ">I"}
        if b in lengths:
            n = self._unpack(lengths[b])
            if b <= 0xC6:
                return bytes(self._take(n))
            if b <= 0xC9:
                return self._ext(n)
            if b <= 0xDB:
                return str(self._take(n), "utf-8")
            if b <= 0xDD:
                return [self.decode() for _ in range(n)]
            return self._map(n)
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self._ext(1 << (b - 0xD4))
        raise ValueError(f"{self.path}: unknown msgpack type byte 0x{b:02x} at {self.pos - 1}")

    def _map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            k = self.decode()
            out[k] = self.decode()
        if "__msgpack_chunked_array__" in out:
            raise ValueError(f"{self.path}: holds an array in flax's chunked form (over 1 GiB), "
                             "which this reader does not take")
        return out

    def _ext(self, n: int) -> np.ndarray:
        code = self._unpack(">b")
        payload = self._take(n)
        if code != _EXT_NDARRAY:
            raise ValueError(f"{self.path}: msgpack extension type {code} is not an array "
                             f"(type {_EXT_NDARRAY}); this reader takes no other")
        shape, dtype, data = _Decoder(bytes(payload), self.path).decode()
        dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
        shape = tuple(int(s) for s in shape)
        if dtype == "bfloat16":
            bits = np.frombuffer(data, dtype="<u2").astype(np.uint32) << 16
            return bits.view(np.float32).reshape(shape)
        return np.frombuffer(data, dtype=np.dtype(dtype)).reshape(shape)


def load_checkpoint(path: Union[str, Path]) -> Dict[str, Any]:
    """A checkpoint file as plain nested dicts with numpy leaves (bf16 -> f32)."""
    decoder = _Decoder(Path(path).read_bytes(), str(path))
    out = decoder.decode()
    if decoder.pos != len(decoder.buf):
        raise ValueError(f"{path}: {len(decoder.buf) - decoder.pos} bytes after the document")
    return out


def _as_f32(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _as_f32(v) for k, v in tree.items()}
    arr = np.asarray(tree)
    return arr.astype(np.float32) if np.issubdtype(arr.dtype, np.floating) else arr


def load_torch_variables(path: Union[str, Path], model_cfg: Union[str, Dict[str, Any], None],
                         prefer_ema: bool = True, nc: Optional[int] = None
                         ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A reference ``.pt`` checkpoint -> (unfused f32 variables, meta).

    The tensors go by name and shape into a template built from
    ``model_cfg`` with ``nc`` classes and ``init_model`` weights (seed 0);
    what does not match keeps the template's value. ``meta`` holds
    ``model_cfg`` (JSON, with the class count used), ``torch_import``,
    ``torch_matched`` and ``torch_unmatched``."""
    from ayolov2_torch.models import build_model, init_model
    from ayolov2_torch.models.builder import parse_model_config
    from ayolov2_torch.utils.torch_import import load_torch_checkpoint, transfer_state_dict
    from ayolov2_torch.utils.weights import flax_from_state_dict

    if not model_cfg:
        # a torch pickle carries no model config that can be trusted
        raise ValueError(f"loading {path}: reference .pt weights need --model-cfg")
    cfg = parse_model_config(model_cfg)
    template = init_model(build_model(cfg, nc=nc, device="cpu"), seed=0)
    sd = load_torch_checkpoint(str(path), prefer_ema=prefer_ema)
    merged, n_matched, unmatched = transfer_state_dict(sd, template.state_dict())
    if unmatched:
        LOGGER.warning("torch import %s: %d matched, %d unmatched (first: %s)",
                       path, n_matched, len(unmatched), unmatched[:5])
    tree = flax_from_state_dict(merged)
    variables = {"params": _as_f32(tree["params"]),
                 "batch_stats": _as_f32(tree.get("batch_stats", {}))}
    meta = {
        "model_cfg": json.dumps({**cfg, "n_classes": int(template.nc)}),
        "torch_import": str(path),
        "torch_matched": int(n_matched),
        "torch_unmatched": len(unmatched),
    }
    return variables, meta


def load_variables(path: Union[str, Path], prefer_ema: bool = True,
                   model_cfg: Union[str, Dict[str, Any], None] = None, nc: Optional[int] = None
                   ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Checkpoint -> ({'params', 'batch_stats'} as f32 numpy trees, meta).

    Takes the ``ema`` branch when there is one and ``prefer_ema``, else
    ``model``; ``meta['model_cfg']`` is the model config as a JSON string.
    A ``.pt`` path is the reference's torch checkpoint, mapped into
    ``model_cfg``'s graph with ``nc`` classes (:func:`load_torch_variables`);
    a ``.ckpt`` ignores both.
    """
    if str(path).endswith(".pt"):
        return load_torch_variables(path, model_cfg, prefer_ema=prefer_ema, nc=nc)
    raw = load_checkpoint(path)
    branch = raw.get("ema") if prefer_ema and raw.get("ema") else raw["model"]
    variables = {"params": _as_f32(branch["params"]),
                 "batch_stats": _as_f32(branch.get("batch_stats", {}))}
    return variables, raw.get("meta", {})


def load_model(path: Union[str, Path], model_cfg: Union[str, Dict[str, Any], None] = None,
               nc: Optional[int] = None, fuse: bool = True, device=None):
    """A checkpoint's model, loaded strict: the graph from ``model_cfg`` or
    else the checkpoint's own config (decomposed as its meta's
    ``decompose_map`` says), ``nc`` classes (default: the config's), BN
    folded when ``fuse``; built on ``device`` (default: the card)."""
    from ayolov2_torch.models import build_model
    from ayolov2_torch.models.builder import parse_model_config
    from ayolov2_torch.utils.weights import load_flax_variables

    variables, meta = load_variables(path, model_cfg=model_cfg, nc=nc)
    cfg = parse_model_config(model_cfg) if model_cfg else json.loads(meta.get("model_cfg") or "{}")
    if not cfg:
        raise ValueError(f"{path} holds no model config; pass one")
    model = build_model(cfg, nc=nc, device=device, decompose_map=decompose_map_of_meta(meta))
    model = load_flax_variables(model, variables)
    return model.fuse() if fuse else model


def decompose_map_of_meta(meta: Dict[str, Any]) -> Dict[str, Tuple[int, int]]:
    """A checkpoint meta's ``decompose_map`` ({} when it has none)."""
    from ayolov2_torch.models.builder import decompose_map_of

    return decompose_map_of(json.loads(meta["decompose_map"])) if meta.get("decompose_map") else {}


# -- the write side -----------------------------------------------------------

def _pack_len(out: bytearray, n: int, fix: Optional[Tuple[int, int]], codes: Tuple[int, ...]) -> None:
    """A length header: the fix form (base, limit) when it fits, else 8/16/32-bit."""
    if fix is not None and n < fix[1]:
        out.append(fix[0] | n)
    elif codes[0] is not None and n < 1 << 8:
        out += struct.pack(">BB", codes[0], n)
    elif n < 1 << 16:
        out += struct.pack(">BH", codes[1], n)
    else:
        out += struct.pack(">BI", codes[2], n)


def _ndarray_bytes(arr) -> bytes:
    """flax's ``_ndarray_to_bytes``: msgpack of (shape, dtype name, C-order bytes)."""
    out = bytearray()
    if isinstance(arr, BF16Bits):
        _pack([list(arr.bits.shape), "bfloat16", arr.bits.tobytes("C")], out)
    else:
        _pack([list(arr.shape), arr.dtype.name, arr.tobytes("C")], out)
    return bytes(out)


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif isinstance(obj, (bool, np.bool_)):
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, (int, np.integer)):
        n = int(obj)
        if 0 <= n < 0x80:
            out.append(n)
        elif -32 <= n < 0:
            out.append(n & 0xFF)
        elif n >= 0:
            for code, fmt, lim in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                   (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
                if n < lim:
                    out += struct.pack(">B", code) + struct.pack(fmt, n)
                    break
        else:
            for code, fmt, lim in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                   (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
                if n >= -lim:
                    out += struct.pack(">B", code) + struct.pack(fmt, n)
                    break
    elif isinstance(obj, (float, np.floating)):
        out += struct.pack(">Bd", 0xCB, float(obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(out, len(data), (0xA0, 32), (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        _pack_len(out, len(obj), None, (0xC4, 0xC5, 0xC6))
        out += bytes(obj)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), (0x80, 16), (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), (0x90, 16), (None, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, (np.ndarray, BF16Bits)):
        payload = _ndarray_bytes(obj)
        n = len(payload)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixext:
            out.append(fixext[n])
        else:
            _pack_len(out, n, None, (0xC7, 0xC8, 0xC9))
        out += struct.pack(">b", _EXT_NDARRAY) + payload
    else:
        raise TypeError(f"cannot write {type(obj).__name__} into a checkpoint")


def dump_checkpoint(payload: Dict[str, Any]) -> bytes:
    """A tree of dicts, lists, scalars and numpy arrays as one msgpack
    document in flax's encoding."""
    out = bytearray()
    _pack(payload, out)
    return bytes(out)


class BF16Bits:
    """A bfloat16 array held as its uint16 bits (numpy has no bfloat16)."""

    def __init__(self, bits: np.ndarray) -> None:
        self.bits = bits

    @staticmethod
    def from_f32(arr: np.ndarray) -> "BF16Bits":
        """Rounded to nearest even, as numpy's and JAX's casts round."""
        t = torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(torch.bfloat16)
        return BF16Bits(t.view(torch.int16).numpy().view(np.uint16))


def _cast_tree(tree: Any, half: bool) -> Any:
    if isinstance(tree, dict):
        return {k: _cast_tree(v, half) for k, v in tree.items()}
    arr = np.asarray(tree)
    if half and np.issubdtype(arr.dtype, np.floating):
        return BF16Bits.from_f32(arr)
    return np.ascontiguousarray(arr, np.float32) if np.issubdtype(arr.dtype, np.floating) else arr


def _variables(model: torch.nn.Module, half: bool) -> Dict[str, Any]:
    from ayolov2_torch.utils.weights import flax_from_state_dict

    tree = flax_from_state_dict(model.state_dict())
    return {"params": _cast_tree(tree["params"], half),
            "batch_stats": _cast_tree(tree.get("batch_stats", {}), False)}


def checkpoint_payload(state, epoch: int, best_score: float = 0.0, map50: Optional[float] = None,
                       model_cfg: Optional[Dict[str, Any]] = None, half: bool = True,
                       include_optimizer: bool = True) -> Dict[str, Any]:
    """The checkpoint of a ``TrainState`` as a tree of host arrays (every
    device copy is made here, so the tree can be written later)."""
    payload: Dict[str, Any] = {
        "meta": {
            "version": CKPT_VERSION,
            "epoch": int(epoch),
            "best_score": float(best_score),
            "map50": -1.0 if map50 is None else float(map50),
            "model_cfg": json.dumps(model_cfg) if model_cfg else "",
            "ema_updates": int(state.ema_updates),
            "step": int(state.step),
            **_decompose_meta(state.model),
        },
        "model": _variables(state.model, half),
        "ema": _variables(state.ema_model, half),
    }
    if include_optimizer:
        payload["optimizer"] = state.optimizer.state_dict()
    return payload


def _decompose_meta(model) -> Dict[str, str]:
    dmap = getattr(model, "decompose_map", None)
    return {"decompose_map": json.dumps({k: list(v) for k, v in dmap.items()})} if dmap else {}


def write_checkpoint(path: Union[str, Path], payload: Dict[str, Any]) -> None:
    """Encode and publish atomically: a tmp file, then a rename, so a crash
    mid-write never leaves a torn ``last.ckpt``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_bytes(dump_checkpoint(payload))
    os.replace(tmp, path)


def save_checkpoint(path: Union[str, Path], state, epoch: int, best_score: float = 0.0,
                    map50: Optional[float] = None, model_cfg: Optional[Dict[str, Any]] = None,
                    half: bool = True, include_optimizer: bool = True) -> None:
    """Write one checkpoint file of a ``TrainState`` (see the module docstring)."""
    write_checkpoint(path, checkpoint_payload(state, epoch, best_score, map50, model_cfg,
                                              half, include_optimizer))


class AsyncCheckpointWriter:
    """Writes checkpoints on one worker thread, in order.

    Torch tensors change in place, so the caller snapshots the state first
    (``checkpoint_payload``, on the training thread: the device copies) and
    submits the encoding and the disk write, which leave the step loop.
    """

    def __init__(self) -> None:
        self._q: "queue.Queue" = queue.Queue()
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True, name="ckpt-writer")
        self._thread.start()

    def _run(self) -> None:
        while True:
            job = self._q.get()
            try:
                job()
            except BaseException as e:  # raised on the next wait()/submit()
                self._err = e
            finally:
                self._q.task_done()

    def submit(self, fn: Callable[[], None]) -> None:
        """Queue a zero-argument save; raises any earlier write's error."""
        self._raise_pending()
        self._q.put(fn)

    def wait(self) -> None:
        """Block until every queued save is on disk."""
        self._q.join()
        self._raise_pending()

    def _raise_pending(self) -> None:
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError("async checkpoint write failed") from err


def _load_into(model: torch.nn.Module, branch: Dict[str, Any]) -> None:
    from ayolov2_torch.utils.weights import state_dict_from_flax

    sd = state_dict_from_flax({"params": branch["params"],
                               "batch_stats": branch.get("batch_stats", {})})
    model.load_state_dict(sd, strict=True)


def restore_train_state(path: Union[str, Path], state) -> Tuple[Any, Dict[str, Any]]:
    """Resume a ``TrainState`` in place from a checkpoint of either package:
    model, EMA, counters and the optimizer's state (the port's layout, or a
    JAX run's optax state, ``Optimizer.load_optax_state``). Returns (state,
    meta)."""
    raw = load_checkpoint(path)
    meta = raw["meta"]
    _load_into(state.model, raw["model"])
    _load_into(state.ema_model, raw["ema"])
    state.ema_updates = int(meta["ema_updates"])
    state.step = int(meta["step"])
    opt = raw.get("optimizer")
    if opt:
        if "kind" in opt:
            state.optimizer.load_state_dict(opt)
        else:
            state.optimizer.load_optax_state(opt, source=str(path))
    return state, meta


def intersect_trees(src: Dict[str, Any], dst: Dict[str, Any]) -> Tuple[Dict[str, Any], int, int]:
    """Shape-matched weight transfer: every leaf of ``src`` whose path exists
    in ``dst`` with the same shape replaces it, in a copy of ``dst``.
    Returns (merged, leaves matched, leaves of ``dst``)."""
    matched = total = 0

    def merge(s, d):
        nonlocal matched, total
        if isinstance(d, dict):
            return {k: merge(s.get(k) if isinstance(s, dict) else None, v) for k, v in d.items()}
        total += 1
        if s is not None and np.asarray(s).shape == np.asarray(d).shape:
            matched += 1
            return np.asarray(s, dtype=np.asarray(d).dtype)
        return d

    merged = merge(src, dst)
    return merged, matched, total
