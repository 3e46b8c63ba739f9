"""Skew-aware registration for in-loop motion de-skew (port of ``icpslam_tpu/ops/skew_icp.py``).

Two Gauss-Newton solvers over skewed lidar sweeps, each point carrying its
capture-time fraction ``u`` (``cloud/deskew.py``):

- :func:`coupled_deskew_icp` warps the skewed TARGET by the transform
  being solved (the previous sweep's smear is the motion this
  registration measures) and the source by the same transform under
  constant velocity, or by a freed source twist (12 unknowns) tied to it
  by a relative prior; the pose information it returns is the Schur
  complement of that twist block.
- :func:`skew_aware_icp` (the ``joint`` mode) solves pose and sweep twist
  against a clean target, with a stiff prior on the twist's translation.

The JAX ``lax.while_loop`` becomes the idiom of ``ops/icp.py``: a Python
loop whose per-point work (warps, the 1-NN kernel K1 on the re-warped
target, residuals, Jacobians and the reduction to H and g) runs on the
tensors' device, and one counted host read per iteration brings H, g and
the few scalars the host needs. The (6×6 or 12×12) solve, the prior, the
``relaxed`` latch of the auto prior and the stopping test run on the
host in float32, like the 6×6 solve of ``ops/icp.py``. The target
changes every iteration, so K1 stages it afresh on every call.

In :func:`coupled_deskew_icp` the device work around K1 is split into
segments over named buffers (:class:`_Iteration`): on a CUDA device each
segment is a CUDA graph, captured at the first call of its shapes and
flags and replayed after (a few launch calls an iteration instead of
hundreds); K1 stays an eager call between them. Elsewhere the same
segments run eagerly.

K1 is exact here: JAX's ``prune_beyond`` cap is ignored (``ops/nn.py``),
and every match beyond ``max_correspondence_distance`` is gated out of
``corr`` again below, so the correspondences are JAX's.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from icpslam_tpu_torch.cloud.deskew import deskew_points
from icpslam_tpu_torch.cloud.pointcloud import PointCloud
from icpslam_tpu_torch.geometry import quaternion as quat
from icpslam_tpu_torch.geometry import se3
from icpslam_tpu_torch.geometry.se3 import Pose
from icpslam_tpu_torch.ops import nn as nn_ops
from icpslam_tpu_torch.ops.icp import MIN_CORRESPONDENCES, _huber_weights
from icpslam_tpu_torch.ops.linalg3 import inv_sym3_comps, rotate_sym3_comps
from icpslam_tpu_torch.utils import cuda_graphs, profiling
from icpslam_tpu_torch.utils.sync import to_host


class SkewIcpResult(NamedTuple):
    pose: Pose                # sweep-START pose of the source in the target frame
    skew_twist: torch.Tensor  # (6,) [t_m | ω_m] motion across the source sweep
    fitness: torch.Tensor
    converged: torch.Tensor
    num_correspondences: torch.Tensor
    iterations: torch.Tensor
    hessian: Optional[torch.Tensor] = None  # (6, 6) pose information


def _basis(p: torch.Tensor) -> torch.Tensor:
    """(N, 3, 6) ``[I | −skew(p)]``."""
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(p.shape[0], 3, 3)
    return torch.cat([eye, -se3.skew(p)], dim=-1)


def _information(plane, R, source_covs, target_covs, idx, n, ref) -> torch.Tensor:
    """(N, 3, 3) per-point weighting: ``(C_dst + R C_src Rᵀ)⁻¹`` in plane
    mode, the identity otherwise."""
    if not plane:
        return torch.eye(3, dtype=ref.dtype, device=ref.device).expand(n, 3, 3)
    ba, bb, bc, bd, be, bf = rotate_sym3_comps(R, tuple(source_covs.unbind(0)))
    tg = target_covs[:, idx]
    Wa, Wb, Wc, Wd, We, Wf = inv_sym3_comps(
        tg[0] + ba, tg[1] + bb, tg[2] + bc, tg[3] + bd, tg[4] + be, tg[5] + bf
    )
    return torch.stack([
        torch.stack([Wa, Wb, Wc], -1),
        torch.stack([Wb, Wd, We], -1),
        torch.stack([Wc, We, Wf], -1),
    ], -2)


def _normal_equations(J, W, r, w):
    """``H = Σ w JᵀWJ`` and ``g = Σ w JᵀW r`` over the points."""
    WJ = torch.einsum("nab,nbk->nak", W, J)
    H = torch.einsum("nak,nal,n->kl", J, WJ, w)
    g = torch.einsum("nak,na,n->k", WJ, r, w)
    return H, g


def _solve(H: np.ndarray, g: np.ndarray) -> np.ndarray:
    """``−(H + 1e-6·tr(H)/n·I)⁻¹ g`` by Cholesky in float32 on the host
    (JAX ``cho_factor``/``cho_solve``); NaN where the factorisation fails."""
    n = H.shape[0]
    A = (H + np.float32(1e-6) * np.trace(H) / np.float32(n) * np.eye(n, dtype=np.float32)).astype(
        np.float32)
    try:
        L = np.linalg.cholesky(A)
    except np.linalg.LinAlgError:
        return np.full((n,), np.nan, np.float32)
    y = np.linalg.solve(L, g.astype(np.float32))
    return (-np.linalg.solve(L.T, y)).astype(np.float32)


def _result(pose, M, d2, corr, it, H6, twist_free: bool, want_hessian: bool) -> SkewIcpResult:
    dtype, dev = d2.dtype, d2.device
    n_corr = corr.sum(dtype=torch.int32)
    fitness = torch.where(
        n_corr > 0,
        torch.where(corr, d2, torch.zeros_like(d2)).sum() / torch.clamp(n_corr, min=1),
        torch.full((), float("inf"), dtype=dtype, device=dev),
    )
    finite = torch.isfinite(pose.t).all() & torch.isfinite(pose.q).all() & torch.isfinite(M).all()
    safe_pose = se3.where(finite, pose, se3.identity(dtype=dtype, device=dev))
    twist = torch.where(finite, M, torch.zeros_like(M)) if twist_free else se3.se3_log(safe_pose)
    hessian = None
    if want_hessian:
        H6 = torch.from_numpy(H6).to(dev)
        hessian = torch.where(torch.isfinite(H6).all(), H6, torch.zeros_like(H6))
    return SkewIcpResult(
        pose=safe_pose, skew_twist=twist, fitness=fitness,
        converged=(n_corr >= MIN_CORRESPONDENCES) & finite,
        num_correspondences=n_corr,
        iterations=torch.tensor(it, dtype=torch.int32, device=dev),
        hessian=hessian,
    )


class _Flags(NamedTuple):
    """What the segments of the coupled GN iteration take as constants."""
    plane: bool
    clean_source: bool       # source_u is None
    free: bool               # free_source_twist
    auto: bool               # auto_prior is not None
    max_d2: float
    huber_delta: float


def _start(x: dict, f: _Flags) -> None:
    """Segment I: the source twist ``M`` from the loaded pose (free twist),
    zero otherwise."""
    if f.free:
        x["M"].copy_(se3.se3_log(Pose(x["t"], x["q"])))
    else:
        x["M"].zero_()


def _update(x: dict, f: _Flags) -> None:
    """Segment U: ``pose ← normalize(exp(δ[:6]) ∘ pose)`` and ``M ← M + δ[6:]``
    in place."""
    delta = x["delta"]
    pose = se3.normalize(se3.compose(se3.se3_exp(delta[:6]), Pose(x["t"], x["q"])))
    x["t"].copy_(pose.t)
    x["q"].copy_(pose.q)
    if f.free:
        x["M"].add_(delta[6:])


def _warp(x: dict, f: _Flags) -> dict:
    """Segment A: the warped source ``P`` in the target frame and the
    warped target ``q_warp``, K1's inputs."""
    pose = Pose(x["t"], x["q"])
    R = quat.to_matrix(pose.q)
    pts = x["pts"]
    if f.clean_source:
        p_warp = pts
    elif f.free:
        p_warp = deskew_points(pts, x["u"], se3.se3_exp(x["M"]))
    else:
        p_warp = deskew_points(pts, x["u"], pose)
    P = (p_warp @ R.T + pose.t[None, :]).contiguous()
    q_warp = deskew_points(x["q_pts"], x["v"], pose).contiguous()
    return {"R": R, "P": P, "q_warp": q_warp}


def _equations(x: dict, f: _Flags) -> dict:
    """Segment B: from K1's ``idx`` and ``dist2``, the residuals, Huber
    weights and Jacobians, reduced to ``s = [H | g | n_corr, n_src, extra]``
    for the host; ``d2`` and ``corr`` for the result."""
    P, R, idx, pts = x["P"], x["R"], x["idx"], x["pts"]
    dtype, n = pts.dtype, pts.shape[0]
    matched = torch.isfinite(x["dist2"])
    q0, v = x["q_pts"][idx], x["v"][idx]
    r = P - x["q_warp"][idx]
    d2 = (r * r).sum(-1)
    corr = x["src_mask"] & matched & (d2 <= f.max_d2)
    w = _huber_weights(torch.sqrt(torch.clamp(d2, min=0.0)), f.huber_delta)
    w = w * corr.to(dtype)
    W = _information(f.plane, R, x.get("src_covs"), x.get("tgt_covs"), idx, n, pts)

    J = _basis(P) - v[:, None, None] * _basis(q0)
    if not f.clean_source:
        J_src = x["u"][:, None, None] * torch.einsum("ab,nbk->nak", R, _basis(pts))
        J = torch.cat([J, J_src], dim=-1) if f.free else J + J_src
    H, g = _normal_equations(J, W, r, w)
    extra = [corr.sum().to(dtype)[None], x["src_mask"].sum().to(dtype)[None]]
    if f.free:
        extra.append(x["M"] - se3.se3_log(Pose(x["t"], x["q"])))
    if f.auto:
        extra.append(torch.linalg.norm(se3.so3_log(x["q"]))[None])
    return {"s": torch.cat([H.reshape(-1), g] + extra), "d2": d2, "corr": corr}


_SEGMENTS = {"start": _start, "update": _update, "warp": _warp, "equations": _equations}


class _Iteration:
    """The device work of one coupled GN iteration, in segments over the
    named buffers ``x``: I (``start``, once), A (``warp``), then K1 by the
    caller, B (``equations``) and U (``update``, after the host's solve).
    Each segment reads its inputs from ``x`` and the outputs of A feed B
    through it. Eagerly (``graphs`` None) each call runs the segment's
    body; captured, it replays the graph of that body, whose static
    buffers ``x`` holds."""

    def __init__(self, x: dict, flags: _Flags, graphs: Optional[dict] = None,
                 outputs: Optional[dict] = None, delta_host: Optional[torch.Tensor] = None):
        self.x, self.flags = x, flags
        self.graphs, self.outputs, self.delta_host = graphs, outputs, delta_host

    @classmethod
    def captured(cls, static: dict, flags: _Flags) -> "_Iteration":
        """Capture the four segments over the buffers ``static`` (their
        contents are overwritten: the warm-ups run the bodies)."""
        dev = static["pts"].device
        graphs, outputs = {}, {}
        for name, fn in _SEGMENTS.items():
            graphs[name], outputs[name] = cuda_graphs.capture(
                functools.partial(fn, static, flags), dev)
            static.update(outputs[name] or {})
        delta_host = torch.empty(static["delta"].shape, dtype=static["delta"].dtype,
                                 pin_memory=True)
        return cls(static, flags, graphs, outputs, delta_host)

    def load(self, inputs: dict) -> None:
        """Copy a call's inputs into the static buffers (captured only)."""
        for name, src in inputs.items():
            self.x[name].copy_(src)

    def run(self, name: str):
        if self.graphs is None:
            out = _SEGMENTS[name](self.x, self.flags)
            self.x.update(out or {})
            return out
        self.graphs[name].replay()
        return self.outputs[name]

    def update(self, delta: np.ndarray) -> None:
        """Upload the host's step and run U."""
        if self.delta_host is None:
            self.x["delta"].copy_(torch.from_numpy(delta))
        else:
            # the host writes the pinned buffer again only after the next
            # to_host, which the stream orders after this copy
            self.delta_host.numpy()[:] = delta
            self.x["delta"].copy_(self.delta_host, non_blocking=True)
        self.run("update")


# the captured iterations, by device, the inputs' shapes and dtypes, and
# the flags (as jax.jit keeps one compiled loop body per shape)
_CAPTURED: Dict[tuple, _Iteration] = {}


def _buffers(x: dict, ndof: int) -> dict:
    """``x`` with the buffers the segments write besides their outputs."""
    pts = x["pts"]
    dev, dtype, n = pts.device, pts.dtype, pts.shape[0]
    return dict(x, M=torch.zeros(6, dtype=dtype, device=dev),
                delta=torch.zeros(ndof, dtype=dtype, device=dev),
                idx=torch.zeros(n, dtype=torch.int64, device=dev),
                dist2=torch.zeros(n, dtype=dtype, device=dev))


def _eager(inputs: dict, flags: _Flags, ndof: int) -> _Iteration:
    """The iteration run segment by segment on the inputs (the pose
    copied: U writes it in place)."""
    x = dict(inputs, t=inputs["t"].clone(), q=inputs["q"].clone())
    return _Iteration(_buffers(x, ndof), flags)


def _iteration(inputs: dict, flags: _Flags, ndof: int) -> _Iteration:
    """The captured iteration for these inputs on a CUDA device (captured
    at first use, loaded with the inputs), the eager one elsewhere."""
    dev = inputs["pts"].device
    if dev.type != "cuda":
        return _eager(inputs, flags, ndof)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (dev, flags) + tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(inputs.items()))
    body = _CAPTURED.get(key)
    if body is None:
        static = _buffers({k: v.clone() for k, v in inputs.items()}, ndof)
        body = _CAPTURED[key] = _Iteration.captured(static, flags)
    body.load(inputs)
    return body


def coupled_deskew_icp(
    source: PointCloud,
    target: PointCloud,
    target_u: torch.Tensor,
    config,
    source_u: Optional[torch.Tensor] = None,
    init: Optional[Pose] = None,
    source_covs: Optional[torch.Tensor] = None,
    target_covs: Optional[torch.Tensor] = None,
    target_valid_len: Optional[torch.Tensor] = None,
    free_source_twist: bool = False,
    source_twist_prior_weight: float = 1.0,
    prior_huber_delta: float = 0.0,
    auto_prior: tuple | None = None,
    want_hessian: bool = False,
) -> SkewIcpResult:
    """Register the skewed ``source`` onto the skewed ``target``, de-skewing
    both with the transform being solved (JAX contract).

    Model, with ``m = log(pose)``: ``p'(u) = p + u·(t_m + ω_m × p)`` for the
    source (``source_u=None`` takes it as clean), ``q'(v)`` likewise for the
    target, ``r = R·p' + t − q'``, left perturbation. The residuals use the
    exact warp (``deskew_points``), the Jacobian its first order.
    ``free_source_twist`` frees the source twist M (6 more unknowns) with
    the prior ``M → log(pose)`` of information ``source_twist_prior_weight``
    per 1,000 source points, Huber-weighted when ``prior_huber_delta > 0``.
    ``auto_prior = (w_straight, w_turn, threshold)`` uses ``w_straight``
    until the pose's rotation angle exceeds ``threshold`` in this solve,
    then ``w_turn`` for the rest of it (a latch).

    On a CUDA device each iteration's work around the K1 call replays
    captured CUDA graphs (:class:`_Iteration`; the counter
    ``skew_icp.captured_iterations`` counts those iterations); elsewhere
    the same segments run eagerly.
    """
    pts = source.points
    dev, dtype = pts.device, pts.dtype
    if init is None:
        init = se3.identity(dtype=dtype, device=dev)
    plane = config.mode == "plane"
    if plane and (source_covs is None or target_covs is None):
        raise ValueError("plane mode requires source_covs and target_covs")
    if free_source_twist and source_u is None:
        raise ValueError("free_source_twist requires source_u — a clean source has no "
                         "sweep twist to estimate")

    n = pts.shape[0]
    max_d2 = config.max_correspondence_distance ** 2
    ndof = 12 if free_source_twist else 6
    f32 = np.float32
    eye6 = np.eye(6, dtype=f32)

    inputs = {"pts": pts, "q_pts": target.points, "v": target_u.to(dtype),
              "src_mask": source.mask, "t": init.t, "q": init.q}
    if source_u is not None:
        inputs["u"] = source_u.to(dtype)
    if plane:
        inputs["src_covs"], inputs["tgt_covs"] = source_covs, target_covs
    flags = _Flags(plane=plane, clean_source=source_u is None, free=free_source_twist,
                   auto=auto_prior is not None, max_d2=float(max_d2),
                   huber_delta=float(config.huber_delta))
    body = _iteration(inputs, flags, ndof)
    x = body.x
    body.run("start")
    it, dnorm, relaxed = 0, float("inf"), False
    eq = None
    H6 = np.zeros((6, 6), f32)
    while it < config.max_iterations and dnorm > config.transformation_epsilon:
        body.run("warp")
        res = nn_ops.nearest_neighbors(
            x["P"], x["q_warp"], target.mask, valid_len=target_valid_len,
            prune_beyond=float(max_d2)
        )
        x["idx"].copy_(res.idx)
        x["dist2"].copy_(res.dist2)
        eq = body.run("equations")
        s = to_host(eq["s"])
        H = s[: ndof * ndof].reshape(ndof, ndof).copy()
        g = s[ndof * ndof : ndof * ndof + ndof].copy()
        n_corr, n_src = s[ndof * ndof + ndof], s[ndof * ndof + ndof + 1]
        rest = s[ndof * ndof + ndof + 2 :]
        if auto_prior is not None:
            # the latch: the angle of every iterate so far, this one included
            relaxed = relaxed or bool(rest[-1] > f32(auto_prior[2]))
        if free_source_twist:
            rp = rest[:6]
            w_pr = f32(1.0)
            if prior_huber_delta > 0:
                dev_n = np.linalg.norm(rp)
                if not dev_n <= prior_huber_delta:
                    w_pr = f32(prior_huber_delta) / max(dev_n, f32(1e-12))
            if auto_prior is None:
                w_prior = f32(source_twist_prior_weight)
            else:
                w_prior = f32(auto_prior[1] if relaxed else auto_prior[0])
            pw = f32(w_prior * (max(n_src, f32(1.0)) / f32(1000.0))) * f32(w_pr)
            H[:6, :6] += pw * eye6
            H[6:, 6:] += pw * eye6
            H[:6, 6:] -= pw * eye6
            H[6:, :6] -= pw * eye6
            g[:6] -= pw * rp
            g[6:] += pw * rp
            # pose information: the Schur complement of the twist block
            Hmm = H[6:, 6:]
            ridge = f32(1e-6) * np.trace(Hmm) / f32(6.0) + f32(1e-12)
            Hmm_i = np.linalg.inv(Hmm + ridge * eye6).astype(f32)
            H6 = (H[:6, :6] - H[:6, 6:] @ Hmm_i @ H[6:, :6]).astype(f32)
        else:
            H6 = H[:6, :6].copy()
        delta = _solve(H, g)
        if not n_corr >= MIN_CORRESPONDENCES:
            delta = np.zeros(ndof, f32)
        dnorm = float(np.linalg.norm(delta))
        body.update(delta)
        it += 1
    profiling.count("icp.iterations", it)
    if body.graphs is not None:
        profiling.count("skew_icp.captured_iterations", it)
    if eq is None:
        d2 = torch.full((n,), float("inf"), dtype=dtype, device=dev)
        corr = torch.zeros(n, dtype=torch.bool, device=dev)
    else:
        d2, corr = eq["d2"], eq["corr"]
    # _result makes new tensors: nothing returned aliases a static buffer
    return _result(Pose(x["t"], x["q"]), x["M"], d2, corr, it, H6, free_source_twist,
                   want_hessian)


def skew_aware_icp(
    source: PointCloud,
    target: PointCloud,
    config,
    sweep_u: torch.Tensor,
    init: Optional[Pose] = None,
    init_skew: Optional[torch.Tensor] = None,
    source_covs: Optional[torch.Tensor] = None,
    target_covs: Optional[torch.Tensor] = None,
    target_valid_len: Optional[torch.Tensor] = None,
    skew_prior_weight: float = 1.0,
    skew_prior_t_factor: float = 100.0,
    want_hessian: bool = False,
) -> SkewIcpResult:
    """Register the skewed ``source`` (capture fractions ``sweep_u``) onto a
    clean ``target``, solving pose and sweep twist (12 unknowns; JAX
    contract). The source warp is linear, ``p' = p + u·(t_m + ω_m × p)``.
    ``init_skew`` (default zeros) seeds the twist and is its prior's mean;
    the prior's information is ``skew_prior_weight`` per 1,000 source
    points, times ``skew_prior_t_factor`` on the translation."""
    pts = source.points
    dev, dtype = pts.device, pts.dtype
    if init is None:
        init = se3.identity(dtype=dtype, device=dev)
    if init_skew is None:
        init_skew = torch.zeros(6, dtype=dtype, device=dev)
    plane = config.mode == "plane"
    if plane and (source_covs is None or target_covs is None):
        raise ValueError("plane mode requires source_covs and target_covs")

    n = pts.shape[0]
    u = sweep_u.to(dtype)
    max_d2 = config.max_correspondence_distance ** 2
    B = _basis(pts)
    f32 = np.float32
    factors = np.array([skew_prior_t_factor] * 3 + [1.0] * 3, f32)

    pose, M = init, init_skew
    it, dnorm = 0, float("inf")
    d2 = torch.full((n,), float("inf"), dtype=dtype, device=dev)
    corr = torch.zeros(n, dtype=torch.bool, device=dev)
    H6 = np.zeros((6, 6), f32)
    while it < config.max_iterations and dnorm > config.transformation_epsilon:
        R = quat.to_matrix(pose.q)
        tm, wm = M[:3], M[3:]
        p_warp = pts + u[:, None] * (tm[None, :] + torch.linalg.cross(wm.expand(n, 3), pts))
        P = (p_warp @ R.T + pose.t[None, :]).contiguous()
        res = nn_ops.nearest_neighbors(
            P, target.points, target.mask, valid_len=target_valid_len,
            prune_beyond=float(max_d2),
        )
        idx = res.idx
        matched = torch.isfinite(res.dist2)
        r = P - target.points[idx]
        d2 = (r * r).sum(-1)
        corr = source.mask & matched & (d2 <= max_d2)
        w = _huber_weights(torch.sqrt(torch.clamp(d2, min=0.0)), config.huber_delta)
        w = w * corr.to(dtype)
        W = _information(plane, R, source_covs, target_covs, idx, n, pts)
        J_M = u[:, None, None] * torch.einsum("ab,nbk->nak", R, B)
        J = torch.cat([_basis(P), J_M], dim=-1)
        H, g = _normal_equations(J, W, r, w)
        s = to_host(torch.cat([
            H.reshape(-1), g, corr.sum().to(dtype)[None], source.mask.sum().to(dtype)[None],
            M - init_skew,
        ]))
        H = s[:144].reshape(12, 12).copy()
        g = s[144:156].copy()
        n_corr, n_src, dm = s[156], s[157], s[158:164]
        H6 = H[:6, :6].copy()  # data-only pose information
        # the prior M → seed, stiff on the twist's translation
        pw = f32(skew_prior_weight * (max(n_src, f32(1.0)) / f32(1000.0))) * factors
        H[6:, 6:] += np.diag(pw)
        g[6:] += pw * dm
        delta = _solve(H, g)
        if not n_corr >= MIN_CORRESPONDENCES:
            delta = np.zeros(12, f32)
        dnorm = float(np.linalg.norm(delta))
        delta_t = torch.from_numpy(delta).to(dev)
        pose = se3.normalize(se3.compose(se3.se3_exp(delta_t[:6]), pose))
        M = M + delta_t[6:]
        it += 1
    profiling.count("icp.iterations", it)
    return _result(pose, M, d2, corr, it, H6, True, want_hessian)
