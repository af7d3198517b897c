"""Why the two packages' int8 PTQ scores part on the CPU (JAX's ``cli/val.py
--int8`` mAP50 0.71837, the port's 0.79454 on chip_smoke's phase-7 set and
labels): one-ulp flips of bf16, which int8 quantization magnifies, not a
fault. ``tests/_int8_parity.py`` makes the layer-by-layer analysis; the
numbers are in PERF.md (section 6). Held here:

- JAX's bf16 SiLU on the CPU computes x * (1 / (1 + exp(-x))) with each of
  its four steps rounded to bf16; the port's ``F.silu`` rounds once. Between
  2^-6 and 2^6 a third of its values are 1-2 ulps apart: the first layer
  (the float stem) already parts there, and every SiLU after it;
- the golden checkpoint quantized by each package in bf16 (absmax, on the
  same batch) gives int8 raw maps within the measured bound: max|d| 0.15 and
  p99.9 0.065 of the peak (measured: 0.146 / 0.050 on the phase-7 set's first
  batch of 32 at 640, up to 0.114 / 0.064 on six small batches)."""

import json

import numpy as np
import torch

from _torch_port_common import GOLDEN, synthetic_image

torch.set_num_threads(1)
MAX_TO_PEAK, P999_TO_PEAK = 0.15, 0.065


def _bf16_bits(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).to(torch.bfloat16).view(torch.int16).numpy().astype(np.int32)


def test_jax_bf16_silu_rounds_each_step():
    import jax
    import jax.numpy as jnp

    bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    x = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    keep = (x.float().abs() >= 2.0 ** -6) & (x.float().abs() <= 2.0 ** 6)
    x = x[keep]
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    want = np.asarray(jax.jit(jax.nn.silu)(xj).astype(jnp.float32))
    steps = (x * (1 / (1 + torch.exp(-x)))).float().numpy()  # bf16 after each op
    np.testing.assert_array_equal(steps, want)
    port = torch.nn.functional.silu(x).float().numpy()
    ulps = np.abs(_bf16_bits(port) - _bf16_bits(want))
    assert len(x) > 3000 and ulps.max() <= 2
    assert 0.2 < (ulps > 0).mean() < 0.5


def test_int8_maps_of_both_packages_within_the_measured_bound():
    import jax
    import jax.numpy as jnp

    from ayolov2_torch.compress.quantize import quantize_model as port_quantize
    from ayolov2_torch.utils.checkpoint import load_model
    from ayolov2_torch.utils.weights import flax_from_state_dict
    from ayolov2_tpu.compress.quantize import quantize_model as jax_quantize
    from ayolov2_tpu.models import fuse_params
    from ayolov2_tpu.utils.checkpoint import load_variables

    weights = str(GOLDEN / "weights/best.ckpt")
    rng = np.random.default_rng(1)
    x = np.stack([synthetic_image(rng, 128, 160) for _ in range(2)])
    variables, meta = load_variables(weights, prefer_ema=True, nc=20)
    fused = jax.tree_util.tree_map(np.asarray, fuse_params(variables))
    xj = jnp.asarray(x).astype(jnp.bfloat16) / 255.0
    jmodel, jvars = jax_quantize(json.loads(meta["model_cfg"]), fused, [xj], dtype=jnp.bfloat16,
                                 nc=20)
    want = jax.jit(lambda v, x: jmodel.apply(v, x, training=True))(jvars, xj)
    model = load_model(weights, nc=20, device="cpu")
    xp = torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16) / 255.0
    qmodel, _ = port_quantize(model.cfg, flax_from_state_dict(model.state_dict()), [xp],
                              dtype=torch.bfloat16, nc=20, device="cpu")
    with torch.no_grad():
        got = qmodel(xp, training=True)
    parted = 0.0
    for g, w in zip(got, want):
        g, w = g.float().numpy(), np.asarray(w.astype(jnp.float32))
        d, peak = np.abs(g - w), np.abs(w).max()
        assert g.shape == w.shape and np.isfinite(g).all()
        assert d.max() <= MAX_TO_PEAK * peak
        assert np.quantile(d, 0.999) <= P999_TO_PEAK * peak
        parted = max(parted, d.max() / peak)
    assert parted > 0.01  # they do part: one-ulp flips, magnified by the quantizer
