"""Tucker-2 conv decomposition with analytic EVBMF rank estimation.

The counterpart of ``ayolov2_tpu/compress/decomposition.py``, the same
host-side f64 numpy (scipy for the bounded noise-variance search, imported
inside :func:`EVBMF`):

  - EVBMF: the global analytic solution of fully-observed variational Bayes
    matrix factorisation (Nakajima, Sugiyama, Babacan & Tomioka, JMLR 2013)
    gives each channel-mode unfolding of a conv kernel its rank;
  - :func:`tucker2`: partial Tucker over the channel modes (HOSVD, then 10
    HOOI steps) -> a 1x1 / kxk / 1x1 conv stack;
  - :func:`decompose_model`: every k > 1 conv of a parameter tree, gated
    on a forward difference on random input, after a binary search of an
    L1-unstructured prune ratio.

The model graph is rebuilt from a ``decompose_map`` {JAX module path
("model_4/m0/cv2"): (rank_in, rank_out)} (``build_model(cfg,
decompose_map=...)``, which translates the paths to the port's module
names) and the transformed parameter tree, both in the JAX package's
layout: kernels HWIO (kh, kw, c_in, c_out), modes 2 (in) and 3 (out).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional, Tuple

import numpy as np

LOGGER = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# EVBMF — global analytic VBMF (Nakajima et al. 2013), rank via singular-value
# thresholding with an empirically estimated noise variance.
# ---------------------------------------------------------------------------


def _tau(x: np.ndarray, alpha: float) -> np.ndarray:
    """tau(x; alpha) = ((x - (1+alpha)) + sqrt((x - (1+alpha))^2 - 4 alpha)) / 2."""
    t = x - (1.0 + alpha)
    return 0.5 * (t + np.sqrt(np.maximum(t * t - 4.0 * alpha, 0.0)))


def _evb_sigma2_objective(
    sigma2: float, L: int, M: int, s: np.ndarray, residual: float, xubar: float
) -> float:
    """Negative free energy as a function of sigma^2 (minimized over a bound)."""
    H = len(s)
    alpha = L / M
    x = s ** 2 / (M * sigma2)

    z1 = x[x > xubar]
    z2 = x[x <= xubar]
    tau_z1 = _tau(z1, alpha)

    term1 = np.sum(z2 - np.log(np.maximum(z2, 1e-300)))
    term2 = np.sum(z1 - tau_z1)
    term3 = np.sum(np.log((tau_z1 + 1.0) / np.maximum(z1, 1e-300)))
    term4 = alpha * np.sum(np.log(tau_z1 / alpha + 1.0))

    return float(term1 + term2 + term3 + term4 + residual / (M * sigma2) + (L - H) * np.log(sigma2))


def EVBMF(Y: np.ndarray, sigma2: Optional[float] = None, H: Optional[int] = None) -> int:
    """Rank of the EVB-optimal low-rank approximation of matrix Y.

    Returns the number of singular values surviving the analytic EVB
    threshold with the (estimated) noise variance; :func:`estimate_ranks`
    takes this count for each channel mode.
    """
    from scipy.optimize import minimize_scalar

    Y = np.asarray(Y, dtype=np.float64)
    L, M = Y.shape
    transposed = False
    if L > M:
        Y = Y.T
        L, M = M, L
        transposed = True
    del transposed  # rank is symmetric under transpose

    if H is None:
        H = L
    alpha = L / M
    tauubar = 2.5129 * np.sqrt(alpha)

    s = np.linalg.svd(Y, compute_uv=False)
    s = s[:H]
    residual = 0.0
    if H < L:
        residual = float(np.sum(np.linalg.svd(Y, compute_uv=False)[H:] ** 2))

    if sigma2 is None:
        xubar = (1.0 + tauubar) * (1.0 + alpha / tauubar)
        eH_ub = int(np.minimum(np.ceil(L / (1.0 + alpha)) - 1, H)) - 1
        eH_ub = max(eH_ub, 0)
        upper_bound = (np.sum(s ** 2) + residual) / (L * M)
        lower_bound = float(max(s[eH_ub] ** 2 / (M * xubar), np.mean(s[eH_ub:] ** 2) / M))
        if lower_bound >= upper_bound or not np.isfinite(lower_bound):
            sigma2 = upper_bound
        else:
            res = minimize_scalar(
                _evb_sigma2_objective,
                args=(L, M, s, residual, xubar),
                bounds=(lower_bound, upper_bound),
                method="bounded",
            )
            sigma2 = float(res.x)

    threshold = np.sqrt(M * sigma2 * (1.0 + tauubar) * (1.0 + alpha / tauubar))
    return int(np.sum(s > threshold))


def estimate_ranks(kernel: np.ndarray) -> Tuple[int, int]:
    """(rank_in, rank_out) from EVBMF on the channel-mode unfoldings.

    kernel: HWIO (kh, kw, c_in, c_out).
    """
    k = np.asarray(kernel, dtype=np.float64)
    unfold_in = np.transpose(k, (2, 0, 1, 3)).reshape(k.shape[2], -1)
    unfold_out = np.transpose(k, (3, 0, 1, 2)).reshape(k.shape[3], -1)
    return EVBMF(unfold_in), EVBMF(unfold_out)


# ---------------------------------------------------------------------------
# Tucker-2 (channel modes) via HOSVD init + HOOI refinement
# ---------------------------------------------------------------------------


def _unfold(t: np.ndarray, mode: int) -> np.ndarray:
    return np.moveaxis(t, mode, 0).reshape(t.shape[mode], -1)


def _mode_dot(t: np.ndarray, m: np.ndarray, mode: int) -> np.ndarray:
    """Tensor x_mode matrix: contracts t's ``mode`` axis with m's columns."""
    out = np.tensordot(t, m, axes=([mode], [0]))  # contracted axis goes last
    return np.moveaxis(out, -1, mode)


def tucker2(
    kernel: np.ndarray, rank_in: int, rank_out: int, n_iter: int = 10
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Partial Tucker over the (c_in, c_out) modes of an HWIO kernel.

    Returns (core (kh, kw, r_in, r_out), U_in (c_in, r_in), U_out (c_out, r_out))
    with kernel ~= core x_2 U_in x_3 U_out.
    """
    k = np.asarray(kernel, dtype=np.float64)

    def top_vecs(mat: np.ndarray, r: int) -> np.ndarray:
        u, _, _ = np.linalg.svd(mat, full_matrices=False)
        return u[:, :r]

    u_in = top_vecs(_unfold(k, 2), rank_in)
    u_out = top_vecs(_unfold(k, 3), rank_out)
    for _ in range(n_iter):  # HOOI
        t = _mode_dot(k, u_out, 3)
        u_in = top_vecs(_unfold(t, 2), rank_in)
        t = _mode_dot(k, u_in, 2)
        u_out = top_vecs(_unfold(t, 3), rank_out)
    core = _mode_dot(_mode_dot(k, u_in, 2), u_out, 3)
    return core, u_in, u_out


def decomposed_conv_params(kernel: np.ndarray, rank_in: int, rank_out: int) -> Dict[str, Any]:
    """HWIO kernel -> {conv_first, conv_core, conv_last} param subtrees."""
    core, u_in, u_out = tucker2(kernel, rank_in, rank_out)
    return {
        "conv_first": {"kernel": u_in[None, None].astype(np.float32)},  # (1,1,cin,rin)
        "conv_core": {"kernel": core.astype(np.float32)},  # (kh,kw,rin,rout)
        "conv_last": {"kernel": np.transpose(u_out)[None, None].astype(np.float32)},  # (1,1,rout,cout)
    }


def reconstruct_kernel(parts: Dict[str, Any]) -> np.ndarray:
    """Inverse of decomposed_conv_params: kernel_hat[h,w,c,o] =
    sum_{r,s} core[h,w,r,s] * U_in[c,r] * U_out_T[s,o]."""
    u_in = np.asarray(parts["conv_first"]["kernel"], np.float64)[0, 0]  # (cin, rin)
    core = np.asarray(parts["conv_core"]["kernel"], np.float64)  # (kh,kw,rin,rout)
    u_out_t = np.asarray(parts["conv_last"]["kernel"], np.float64)[0, 0]  # (rout, cout)
    return np.einsum("hwrs,cr,so->hwco", core, u_in, u_out_t)


def _forward_loss(kernel: np.ndarray, approx: np.ndarray, x: np.ndarray) -> float:
    """Mean abs diff of single-position conv outputs on random input x
    (one output position per sample: x is (N, kh, kw, cin))."""
    # x: (N, kh, kw, cin); out[n, o] = sum_{h,w,c} x * kernel
    o1 = np.tensordot(x, kernel, axes=([1, 2, 3], [0, 1, 2]))
    o2 = np.tensordot(x, approx, axes=([1, 2, 3], [0, 1, 2]))
    return float(np.mean(np.abs(o1 - o2)))


def _l1_prune(kernel: np.ndarray, ratio: float) -> np.ndarray:
    """Zero the smallest-|w| ``ratio`` fraction (as torch's l1_unstructured prunes)."""
    if ratio <= 0:
        return kernel
    flat = np.abs(kernel).reshape(-1)
    k = int(len(flat) * ratio)
    if k == 0:
        return kernel
    thr = np.partition(flat, k - 1)[k - 1]
    return np.where(np.abs(kernel) <= thr, 0.0, kernel)


def _walk_conv_kernels(params: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    """Yield (module_path_tuple, kernel) for every ConvBnAct 'conv' kernel."""
    for key, val in params.items():
        if not isinstance(val, dict):
            continue
        if key == "conv" and "kernel" in val:
            yield prefix, np.asarray(val["kernel"])
        else:
            yield from _walk_conv_kernels(val, prefix + (key,))


def _get_subtree(tree: Dict[str, Any], path: Tuple[str, ...]) -> Dict[str, Any]:
    for p in path:
        tree = tree[p]
    return tree


def decompose_model(
    params: Dict[str, Any],
    loss_thr: float = 0.1,
    prune_step: float = 0.01,
    n_test: int = 1024,
    min_channels: int = 8,
    seed: int = 0,
) -> Tuple[Dict[str, Tuple[int, int]], Dict[str, Any], Dict[str, Any]]:
    """Decompose every eligible conv in a param tree (the JAX package's
    layout, numpy leaves):
      - only k>1 convs are considered (1x1s skipped)
      - per-conv gate: forward diff on random input must stay < ``loss_thr``
      - before decomposition, binary-search the largest L1-unstructured
        prune ratio whose decomposed loss stays < ``loss_thr`` (step
        granularity ``prune_step``; 0 disables pruning)

    Returns:
        (decompose_map {path_str: (r_in, r_out)}, new_params, report)
    """
    import copy

    new_params = copy.deepcopy(params)
    decompose_map: Dict[str, Tuple[int, int]] = {}
    report: Dict[str, Any] = {"layers": []}
    rng = np.random.default_rng(seed)

    for path, kernel in list(_walk_conv_kernels(params)):
        kh, kw, cin, cout = kernel.shape
        if kh <= 1 or kw <= 1 or cin < min_channels or cout < min_channels:
            continue
        r_in, r_out = estimate_ranks(kernel)
        r_in, r_out = max(r_in, 2), max(r_out, 2)
        old_cost = kh * kw * cin * cout
        new_cost = cin * r_in + kh * kw * r_in * r_out + r_out * cout
        if new_cost >= old_cost:
            continue

        x = rng.standard_normal((n_test, kh, kw, cin))
        k64 = np.asarray(kernel, np.float64)

        def reconstruct(k_src: np.ndarray) -> Tuple[float, Dict[str, Any]]:
            parts = decomposed_conv_params(k_src, r_in, r_out)
            return _forward_loss(k64, reconstruct_kernel(parts), x), parts

        base_loss, base_parts = reconstruct(k64)
        if base_loss >= loss_thr:
            report["layers"].append(
                {"path": "/".join(path), "skipped": True, "loss": base_loss}
            )
            continue

        # binary search the max prune ratio under the loss threshold
        best_parts, best_ratio = base_parts, 0.0
        if prune_step > 0:
            lo, hi = 0.0, 1.0
            while hi - lo > prune_step:
                mid = (lo + hi) / 2
                loss, parts = reconstruct(_l1_prune(k64, mid))
                if loss < loss_thr:
                    lo, best_parts, best_ratio = mid, parts, mid
                else:
                    hi = mid

        sub = _get_subtree(new_params, path)
        del sub["conv"]
        for k, v in best_parts.items():
            sub[k] = v
        decompose_map["/".join(path)] = (r_in, r_out)
        report["layers"].append(
            {
                "path": "/".join(path),
                "ranks": [r_in, r_out],
                "params": [int(old_cost), int(new_cost)],
                "prune_ratio": round(best_ratio, 4),
                "loss": round(base_loss, 6),
            }
        )
        LOGGER.info(
            "decomposed %s: (%d,%d,%d,%d) -> ranks (%d, %d), %d -> %d params, prune %.2f",
            "/".join(path), kh, kw, cin, cout, r_in, r_out, old_cost, new_cost, best_ratio,
        )

    return decompose_map, new_params, report
