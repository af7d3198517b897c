"""The fused early-network CUDA kernel against its plain version, on the
card. Skips where there is no CUDA device (the kernel has no CPU mode);
``chip_smoke.py`` runs the same check at full size.

Run on a machine with a GPU:  python -m pytest tests/test_torch_port_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from _torch_port_common import images, p999_to_peak, rel_to_peak

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the early-network kernel runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _seeded_ep(variant, seed, device):
    from ayolov2_torch.models import build_model, yolov5_cfg
    from ayolov2_torch.ops.early_pipeline import extract_early_params

    torch.manual_seed(seed)
    model = build_model(yolov5_cfg(variant), device="cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bn.weight"):
                p.uniform_(0.8, 1.2)
            elif name.endswith("bn.bias"):
                p.normal_(0, 0.1)
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.normal_(0, 0.1)
            elif name.endswith("running_var"):
                b.uniform_(0.5, 1.5)
    return extract_early_params(model.fuse().state_dict()).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("variant,shape", [
    ("s", (2, 64, 64)), ("s", (3, 72, 136)), ("m", (1, 96, 64)), ("n", (2, 136, 72)),
    # a ragged last tile in each direction at each model's tile (s 8x8, n 8x16,
    # m 4x8, l 4x4, x 2x2), and an image smaller than one tile
    ("s", (3, 200, 104)), ("s", (1, 8, 8)), ("n", (2, 136, 200)), ("m", (2, 104, 184)),
    ("l", (1, 72, 88)), ("x", (1, 40, 72)),
])
def test_kernel_matches_plain_version(cuda, variant, shape):
    from ayolov2_torch.ops import early_pipeline as early

    ep = _seeded_ep(variant, 0, cuda)
    imgs = torch.from_numpy(images((*shape, 3), seed=shape[1])).to(cuda)
    before = early.early_pipeline.launches
    got = early.early_pipeline(imgs, ep)
    torch.cuda.synchronize()
    assert early.early_pipeline.launches == before + 1
    want = early.early_pipeline_ref(imgs, ep)
    g, w = got.float().cpu().numpy(), want.float().cpu().numpy()
    assert np.isfinite(g).all()
    assert rel_to_peak(g, w) < 0.03
    assert p999_to_peak(g, w) < 0.015
