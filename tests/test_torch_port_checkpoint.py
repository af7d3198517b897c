"""The port's checkpoint reader against flax's, leaf by leaf: checkpoints
written by the JAX package's ``save_checkpoint`` and the committed golden
one."""

from types import SimpleNamespace

import msgpack
import numpy as np
import optax
import pytest
from flax import serialization

from _torch_port_common import GOLDEN
from ayolov2_tpu.utils import checkpoint as jax_ckpt
from ayolov2_torch.utils import checkpoint as port_ckpt


def _assert_tree_equal(got, want, path=""):
    """``want`` is flax's tree: bf16 leaves compare as their exact f32."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray):
        want = want.astype(np.float32) if want.dtype.name == "bfloat16" else want
        assert got.shape == want.shape and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


def _state(seed):
    rng = np.random.default_rng(seed)
    params = {"model_0": {"conv": {"kernel": rng.normal(size=(3, 3, 3, 8)).astype(np.float32)},
                          "bn": {"scale": rng.uniform(0.5, 1.5, 8).astype(np.float32),
                                 "bias": rng.normal(size=8).astype(np.float32)}},
              "model_1": {"m0": {"kernel": rng.normal(size=(1, 1, 8, 30)).astype(np.float32),
                                 "bias": np.full(30, -3.5, np.float32)}}}
    stats = {"model_0": {"bn": {"mean": rng.normal(size=8).astype(np.float32),
                                "var": rng.uniform(0.5, 2.0, 8).astype(np.float32)}}}
    ema = {k: {m: {n: v * 0.5 for n, v in d.items()} for m, d in sub.items()}
           for k, sub in params.items()}
    opt = optax.chain(optax.add_decayed_weights(5e-4), optax.sgd(0.01, momentum=0.9)).init(params)
    return SimpleNamespace(params=params, batch_stats=stats, ema_params=ema,
                           ema_batch_stats=stats, opt_state=opt, ema_updates=np.int32(40),
                           step=np.int32(41))


@pytest.mark.parametrize("half", [True, False])
@pytest.mark.parametrize("optimizer", [True, False])
def test_reader_equals_flax_on_jax_checkpoints(tmp_path, half, optimizer):
    path = tmp_path / "last.ckpt"
    jax_ckpt.save_checkpoint(path, _state(1), epoch=7, best_score=0.25, map50=0.5,
                             model_cfg={"n_classes": 20, "anchors": [[10, 13]]}, half=half,
                             include_optimizer=optimizer)
    got = port_ckpt.load_checkpoint(path)
    want = serialization.msgpack_restore(path.read_bytes())
    assert ("optimizer" in got) == optimizer
    _assert_tree_equal(got, want)
    variables, meta = port_ckpt.load_variables(path)
    want_vars, want_meta = jax_ckpt.load_variables(path)
    _assert_tree_equal(variables, {k: dict(v) for k, v in want_vars.items()})
    assert meta == want_meta and meta["epoch"] == 7
    variables, _ = port_ckpt.load_variables(path, prefer_ema=False)
    np.testing.assert_array_equal(variables["params"]["model_1"]["m0"]["bias"], -3.5)


def test_reader_equals_flax_on_the_golden_checkpoint():
    path = GOLDEN / "weights/best.ckpt"
    raw = path.read_bytes()
    got = port_ckpt.load_checkpoint(path)
    _assert_tree_equal(got, serialization.msgpack_restore(raw))
    variables, meta = port_ckpt.load_variables(path)
    want_vars, want_meta = jax_ckpt.load_variables(path)
    _assert_tree_equal(variables, want_vars)
    assert meta == want_meta


def test_load_model_is_strict_and_takes_the_embedded_config():
    import torch

    from _torch_port_common import golden_variables, port_model

    model = port_ckpt.load_model(GOLDEN / "weights/best.ckpt", nc=20, fuse=False, device="cpu")
    want = port_model("s", golden_variables(), nc=20).state_dict()
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="size mismatch"):
        port_ckpt.load_model(GOLDEN / "weights/best.ckpt", device="cpu")  # the config's nc 80


def test_reader_refuses_what_it_does_not_take(tmp_path):
    cases = {
        "chunked": msgpack.packb({"a": {"__msgpack_chunked_array__": True, "shape": {"0": 2}}}),
        "ext3": msgpack.packb({"a": msgpack.ExtType(3, b"\x00")}),
        "truncated": msgpack.packb({"a": b"x" * 40})[:-5],
    }
    messages = {"chunked": "chunked", "ext3": "extension type 3", "truncated": "truncated"}
    for name, data in cases.items():
        (tmp_path / name).write_bytes(data)
        with pytest.raises(ValueError, match=messages[name]):
            port_ckpt.load_checkpoint(tmp_path / name)
    # a reference .pt is read into the model config's graph, and needs one
    import torch

    from _torch_port_common import CFG
    from ayolov2_torch.models import build_model

    sd = build_model(CFG["n"], nc=3, device="cpu").state_dict()
    torch.save({"ema": sd}, tmp_path / "best.pt")
    variables, meta = port_ckpt.load_variables(tmp_path / "best.pt", model_cfg=CFG["n"], nc=3)
    assert meta["torch_matched"] == sum(not k.endswith("num_batches_tracked") for k in sd)
    assert meta["torch_unmatched"] == 0 and "kernel" in variables["params"]["model_0"]["conv"]
    with pytest.raises(ValueError, match="need --model-cfg"):
        port_ckpt.load_variables(tmp_path / "best.pt")


def test_every_msgpack_type_decodes_like_msgpack(tmp_path):
    doc = {"ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32, -33, -128, -129,
                    -2 ** 15 - 1, -2 ** 31 - 1, 2 ** 63],
           "floats": [0.5, -1e300], "flags": [True, False, None], "bin": b"\x00" * 300,
           "strs": ["", "x" * 31, "y" * 32, "z" * 300, "ü" * 40000], "list": list(range(20)),
           "big": {str(i): i for i in range(70000)}}
    (tmp_path / "d").write_bytes(msgpack.packb(doc, use_bin_type=True))
    assert port_ckpt.load_checkpoint(tmp_path / "d") == msgpack.unpackb(
        msgpack.packb(doc, use_bin_type=True), raw=False, strict_map_key=False)
