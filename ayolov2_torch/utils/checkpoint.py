"""Reading the JAX package's checkpoints without flax or msgpack.

The counterpart of the read side of ``ayolov2_tpu/utils/checkpoint.py``. A
checkpoint is one msgpack document as ``flax.serialization.msgpack_serialize``
writes it: nested maps with string keys, ``meta`` scalars, and every array
as msgpack extension type 1 holding a packed ``(shape, dtype name, bytes)``
(``flax.serialization._ndarray_to_bytes``). :func:`load_checkpoint` decodes
that with a small decoder of its own, so the card's machine needs neither
package. ``bfloat16`` arrays (the half-precision storage of
``save_checkpoint``) come back as float32, exactly: a bf16 value is the high
16 bits of the f32 one.

Not read: flax's chunked form of arrays above 1 GiB and any other extension
type (both raise), and the reference's ``.pt`` checkpoints (a later slice).
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np

_EXT_NDARRAY = 1


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


def load_variables(path: Union[str, Path], prefer_ema: bool = True
                   ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Checkpoint -> ({'params', 'batch_stats'} as f32 numpy trees, meta).

    Takes the ``ema`` branch when there is one and ``prefer_ema``, else
    ``model``; ``meta['model_cfg']`` is the model config as a JSON string.
    """
    if str(path).endswith(".pt"):
        raise NotImplementedError(
            f"{path}: the reference's .pt checkpoints are not read yet (a later slice of the "
            "port); convert it with the JAX package or pass a .ckpt")
    raw = load_checkpoint(path)
    branch = raw.get("ema") if prefer_ema and raw.get("ema") else raw["model"]
    variables = {"params": _as_f32(branch["params"]),
                 "batch_stats": _as_f32(branch.get("batch_stats", {}))}
    return variables, raw.get("meta", {})


def load_model(path: Union[str, Path], model_cfg: Union[str, Dict[str, Any], None] = None,
               nc: Optional[int] = None, fuse: bool = True, device=None):
    """A checkpoint's model, loaded strict: the graph from ``model_cfg`` or
    else the checkpoint's own config, ``nc`` classes (default: the config's),
    BN folded when ``fuse``; built on ``device`` (default: the card)."""
    from ayolov2_torch.models import build_model
    from ayolov2_torch.models.builder import parse_model_config
    from ayolov2_torch.utils.weights import load_flax_variables

    variables, meta = load_variables(path)
    cfg = parse_model_config(model_cfg) if model_cfg else json.loads(meta.get("model_cfg") or "{}")
    if not cfg:
        raise ValueError(f"{path} holds no model config; pass one")
    model = load_flax_variables(build_model(cfg, nc=nc, device=device), variables)
    return model.fuse() if fuse else model
