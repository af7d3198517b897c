"""The native runner on the CPU: ``ayolov2::early_pipeline`` registered
from C++ (``csrc/early_pipeline_op.cpp``), an AOTInductor package of a
serving artifact with the operator in its graph (``export/aoti.py``) and the
C++ runner (``csrc/aoti_runner.cpp``) serving it without Python, against
``load_exported`` of the same ``.pt2`` and JAX's ``export_serving`` ->
``load_exported`` on the same weights and batch (as
``tests/test_pjrt_runner_e2e.py`` holds its runner to the JAX artifact).

Each subprocess has its own time limit; the file skips only where the host
has no C++ compiler."""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from _torch_port_common import ROOT, images, seeded_head_variables, zoo_cfg

torch.set_num_threads(1)
BS, IMG = 2, 64
# (c0, c1, ch, c2) of yolov5n and of the width-1.05 config, at C3 depths 1 and 3
WIDTH_SETS = ((16, 32, 16, 64), (72, 136, 68, 272))
CPU_ENV = {**os.environ, "OMP_NUM_THREADS": "1"}


def _run(args, timeout=120, env=CPU_ENV):
    return subprocess.run([str(a) for a in args], cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout, env=env)


@pytest.fixture(scope="module")
def packaged(tmp_path_factory):
    """yolov5n (seeded weights, nc 80) exported on the CPU at bs 2, 64 px
    with the early-network operator in the graph (its CPU body the plain
    version), twice: f32 with the NMS, and bf16 decoded predictions; both
    packaged at once, each ``package_serving`` in a subprocess of its own,
    while the registration and the runner are built (``_build``)."""
    from ayolov2_torch.export import export_serving
    from ayolov2_torch.ops import _build

    try:
        _build._cxx()
    except RuntimeError as e:
        pytest.skip(f"no host C++ compiler: {e}")
    tmp = tmp_path_factory.mktemp("runner")
    v = seeded_head_variables("yolov5n", 41)
    common = dict(batch_size=BS, img_size=(IMG, IMG), platforms=("cpu",), early_pipeline=True)
    paths = {"f32": export_serving(zoo_cfg("yolov5n"), v, str(tmp / "n"), half=False, **common),
             "bf16": export_serving(zoo_cfg("yolov5n"), seeded_head_variables("yolov5n", 43),
                                    str(tmp / "h"), half=True, include_nms=False, **common)}
    procs = {k: subprocess.Popen(
        [sys.executable, "-c", "import sys; from ayolov2_torch.export.aoti import "
         f"package_serving; package_serving({p['pt2']!r})"], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for k, p in paths.items()}
    _build.build_all([], [(name, ()) for name in _build.TORCH_SOURCES])
    for k, proc in procs.items():
        out, _ = proc.communicate(timeout=200)
        assert proc.returncode == 0, out
    return types.SimpleNamespace(
        tmp=tmp, v=v, paths=paths, aoti={k: p["pt2"][:-4] + ".aoti.pt2" for k, p in paths.items()},
        op=_build.path("early_pipeline_op"), runner=_build.path("aoti_runner"))


@pytest.fixture(scope="module")
def served(packaged):
    """The f32 package served by the runner on a seeded batch (one
    verification call dumped); ``load_exported`` of the ``.pt2`` on the same
    batch."""
    from ayolov2_torch.export import load_exported

    tmp, paths, aoti = packaged.tmp, packaged.paths["f32"], packaged.aoti["f32"]
    x = images((BS, IMG, IMG, 3), seed=42)
    (tmp / "x.bin").write_bytes(x.tobytes())
    r = _run([packaged.runner, "--program", aoti, "--device", "cpu", "--batch", BS, "--height",
              IMG, "--width", IMG, "--iters", 2, "--warmup", 1,
              "--input", tmp / "x.bin", "--dump-output", tmp / "cpp"], timeout=180)
    assert r.returncode == 0, r.stdout + r.stderr
    torch.set_num_threads(1)  # as the runner's OMP_NUM_THREADS: the sums' order follows it
    det, n = load_exported(paths["pt2"])(x)
    return types.SimpleNamespace(
        tmp=tmp, v=packaged.v, x=x, paths=paths, aoti=aoti, stdout=r.stdout,
        want=(det.numpy(), n.numpy()),
        got=(np.fromfile(tmp / "cpp.out0.bin", np.float32).reshape(det.shape),
             np.fromfile(tmp / "cpp.out1.bin", np.int32)))


def test_package_holds_the_operator_and_its_sidecar(served):
    """The artifact's graph calls ``ayolov2::early_pipeline``; the sidecar's
    ``aoti`` section names the package and lists the call's widths, and a
    CPU package needs no kernel library or plan."""
    program = torch.export.load(served.paths["pt2"])
    ops = [n.target for n in program.graph.nodes if n.op == "call_function"]
    assert ops.count(torch.ops.ayolov2.early_pipeline.default) == 1
    side = json.loads(open(served.paths["yaml"]).read())
    assert side["early_pipeline"] is True and side["platforms"] == ["cpu"]
    aoti = side["aoti"]
    assert aoti["package"] == "n.aoti.pt2" and aoti["device"] == "cpu" and aoti["openmp"]
    assert aoti["early_pipeline"] == [{"widths": [16, 32, 16, 64, 1]}]
    assert aoti["compile_s"] > 0


def test_runner_equals_load_exported_bit_for_bit(served):
    """The runner's dumped outputs equal ``load_exported`` of the same
    ``.pt2`` on the same batch, bit for bit; its lines are pjrt_runner's,
    and the CPU body launches no kernel."""
    det, n = served.got
    np.testing.assert_array_equal(n, served.want[1])
    np.testing.assert_array_equal(det, served.want[0])
    assert n.sum() > 0
    lines = served.stdout.splitlines()
    assert lines[0] == "platform: cpu"
    assert lines[1] == f"compiled {served.aoti} (2 outputs)"
    assert lines[-3] == f"benchmark: 2 iters of ({BS}, {IMG}, {IMG}, 3) uint8"
    assert lines[-2].startswith("total ") and lines[-2].endswith(" img/s")
    assert lines[-1] == "early_pipeline launches: 0 (warm-up 1, verification 1, timed 2)"


def test_bf16_package_rounds_as_the_artifact(packaged, tmp_path):
    """A bf16 package (the serving dtype; decoded predictions, the
    early network's operator inside) served by the runner equals the
    ``.pt2`` bit for bit: the package rounds each fused step's result to
    bf16 where eager torch does (``emulate_precision_casts``)."""
    from ayolov2_torch.export import load_exported

    x = images((BS, IMG, IMG, 3), seed=44)
    (tmp_path / "x.bin").write_bytes(x.tobytes())
    r = _run([packaged.runner, "--program", packaged.aoti["bf16"], "--device", "cpu", "--batch",
              BS, "--height", IMG, "--width", IMG, "--iters", 1, "--warmup", 0,
              "--input", tmp_path / "x.bin", "--dump-output", tmp_path / "cpp"], timeout=180)
    assert r.returncode == 0, r.stdout + r.stderr
    torch.set_num_threads(1)
    want = load_exported(packaged.paths["bf16"]["pt2"])(x).numpy()
    got = np.fromfile(tmp_path / "cpp.out0.bin", np.float32).reshape(want.shape)
    assert want.shape == (BS, 3 * (8 * 8 + 4 * 4 + 2 * 2), 85)
    np.testing.assert_array_equal(got, want)


def test_runner_matches_jax_exported_graph(served):
    """Against JAX's ``export_serving`` -> ``load_exported`` on the same
    weights and batch, as ``test_pjrt_runner_e2e.py`` holds its runner:
    same counts, every runner detection matched by a JAX one of the same
    class within 0.5 px and 1e-4 in score, the top row equal within rtol
    1e-2, atol 5e-2. (The port's early network rounds to bf16 between its
    layers, as the kernel does; JAX's artifact runs f32.)"""
    from ayolov2_tpu.export import export_serving as jax_export
    from ayolov2_tpu.export import load_exported as jax_load

    jp = jax_export(zoo_cfg("yolov5n"), served.v, str(served.tmp / "jax_n"), batch_size=BS,
                    img_size=(IMG, IMG), half=False, platforms=("cpu",))
    det_j, n_j = (np.asarray(r) for r in jax_load(jp["jaxexp"])(served.x))
    det, n = served.got
    np.testing.assert_array_equal(n, n_j.astype(np.int32))
    for i in range(BS):
        k = int(n_j[i])
        assert k > 0
        cpp_rows, jax_rows = det[i, :k], det_j[i, :k]
        matched = 0
        for row in cpp_rows:
            same_cls = jax_rows[jax_rows[:, 5] == row[5]]
            matched += bool(len(same_cls) and np.any(
                (np.abs(same_cls[:, :4] - row[:4]).max(axis=1) < 0.5)
                & (np.abs(same_cls[:, 4] - row[4]) < 1e-4)))
        assert matched == k, f"image {i}: {matched}/{k} detections matched"
        np.testing.assert_allclose(cpp_rows[0], jax_rows[0], rtol=1e-2, atol=5e-2)


_DIRECT = """
import sys, numpy as np, torch
torch.set_num_threads(1)
torch.ops.load_library({op!r})
d = np.load({src!r})
out = {{}}
for name in {names!r}:
    c0, c1, ch, c2, n = (int(v) for v in d[name + "_widths"])
    y = torch.ops.ayolov2.early_pipeline(torch.from_numpy(d[name + "_x"]),
        torch.from_numpy(d[name + "_w"]).view(torch.bfloat16), c0, n, c1, ch, c2)
    out[name] = y.view(torch.int16).numpy()
np.savez({dst!r}, **out)
print("python modules of the port:", sorted(m for m in sys.modules if m.startswith("ayolov2")))
"""


def test_registration_cpu_body_equals_early_pipeline_ref(packaged, tmp_path):
    """In a fresh interpreter that never imports the Python operator,
    ``torch.ops.load_library`` of the registration and a direct call equal
    ``early_pipeline_ref``'s saved output bit for bit, at two width sets and
    C3 depths 1 and 3 (packed by ``pack_weights``)."""
    from ayolov2_torch.ops import early_pipeline as early

    rng = np.random.default_rng(3)
    saved, want = {}, {}
    for c0, c1, ch, c2 in WIDTH_SETS:
        for n in (1, 3):
            def mat(co, k):
                return torch.from_numpy(rng.standard_normal((co, k)).astype(np.float32)
                                        * 0.2).to(torch.bfloat16)

            def vec(co):
                return torch.from_numpy(rng.standard_normal(co).astype(np.float32)
                                        * 0.1).to(torch.bfloat16)

            k16 = lambda k: -(-k // 16) * 16  # noqa: E731
            ep = early.EarlyParams(
                mat(c0, 112), vec(c0), mat(c1, k16(9 * c0)), vec(c1), mat(ch, c1), vec(ch),
                tuple(mat(ch, ch) for _ in range(n)), tuple(vec(ch) for _ in range(n)),
                tuple(mat(ch, k16(9 * ch)) for _ in range(n)), tuple(vec(ch) for _ in range(n)),
                mat(ch, c1), vec(ch), mat(c1, k16(2 * ch)), vec(c1), mat(c2, k16(9 * c1)),
                vec(c2))
            name = f"c{c0}_n{n}"
            x = torch.from_numpy(images((2, 32, 48, 3), seed=c0 + n))
            saved.update({name + "_x": x.numpy(), name + "_widths": np.array([c0, c1, ch, c2, n]),
                          name + "_w": early.pack_weights(ep).view(torch.int16).numpy()})
            want[name] = early.early_pipeline_ref(x, ep).view(torch.int16).numpy()
    np.savez(tmp_path / "in.npz", **saved)
    code = _DIRECT.format(op=str(packaged.op), src=str(tmp_path / "in.npz"), names=sorted(want),
                          dst=str(tmp_path / "out.npz"))
    r = _run([sys.executable, "-c", code])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "python modules of the port: []" in r.stdout
    got = np.load(tmp_path / "out.npz")
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_registration_rejects_a_missing_kernel_library(packaged, tmp_path):
    """``ayolov2_early_pipeline_configure`` of a library that does not load
    returns -1 and says why; the launch count starts at 0."""
    code = (
        "import ctypes, sys\n"
        f"lib = ctypes.CDLL({str(packaged.op)!r}, mode=ctypes.RTLD_GLOBAL)\n"
        "lib.ayolov2_early_pipeline_error.restype = ctypes.c_char_p\n"
        "lib.ayolov2_early_pipeline_launches.restype = ctypes.c_int64\n"
        "widths = (ctypes.c_int64 * 5)(16, 32, 16, 64, 1)\n"
        "plan = (ctypes.c_int * 14)(*range(14))\n"
        f"rc = lib.ayolov2_early_pipeline_configure({str(tmp_path / 'none.so')!r}.encode(), "
        "widths, plan)\n"
        "print(rc, lib.ayolov2_early_pipeline_launches(), lib.ayolov2_early_pipeline_error()"
        ".decode())\n"
    )
    r = _run([sys.executable, "-c", code])
    assert r.returncode == 0, r.stdout + r.stderr
    rc, launches, msg = r.stdout.split(" ", 2)
    assert (rc, launches) == ("-1", "0")
    assert "cannot load" in msg and "none.so" in msg


def test_runner_needs_cuda_where_it_is_asked_for(packaged, served, monkeypatch):
    """``--device cuda`` (the default) exits non-zero where CUDA is absent:
    the runner never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the check is for a host without it")
    for device in (["--device", "cuda"], []):
        r = _run([packaged.runner, "--program", served.aoti, *device, "--batch", BS, "--height",
                  IMG, "--width", IMG, "--iters", 1, "--warmup", 0])
        assert r.returncode == 1, r.stdout + r.stderr
        assert "CUDA is not available" in r.stderr
        assert "benchmark:" not in r.stdout


def test_runner_refuses_bad_arguments_and_sidecars(packaged, served, tmp_path):
    """A missing flag value or an unknown flag exits 2 with the usage; a
    sidecar that is not JSON exits 1 naming the byte."""
    r = _run([packaged.runner, "--program"])
    assert r.returncode == 2 and "usage: aoti_runner" in r.stderr
    r = _run([packaged.runner, "--program", served.aoti, "--plugin", "x.so"])
    assert r.returncode == 2 and "unknown arg: --plugin" in r.stderr
    bad = tmp_path / "bad.yaml"
    bad.write_text('{"aoti": [1, 2')
    r = _run([packaged.runner, "--program", served.aoti, "--device", "cpu", "--sidecar", bad])
    assert r.returncode == 1 and "sidecar JSON" in r.stderr
