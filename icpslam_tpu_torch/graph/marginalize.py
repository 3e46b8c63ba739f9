"""Keyframe marginalization: missions outlive ``max_keyframes`` (port of
``icpslam_tpu/graph/marginalize.py``).

- :func:`select_victim` picks the most redundant frozen keyframe: the
  least sum of distances to its two neighbours, plus a penalty per
  incident loop edge, never node 0 (the gauge) or the recent trail.
- :func:`marginalize_keyframe` composes the victim ``v`` into its
  predecessor ``p = v − 1``: every edge on ``v`` is re-homed to ``p``
  through the hop ``Z_pv`` with first-order SE(3) covariance composition,
  the hop (and a wheel twin of it) becomes a self-edge and is dropped,
  parallel edges are fused (:func:`fuse_duplicate_edges`), and both
  stores are compacted so that index order stays temporal order.

Everything runs on the device with static shapes; the victim is a 0-d
tensor and nothing is read on the host. JAX's tie rules are kept: stable
sorts (``torch.argsort(..., stable=True)``, bool keys as int), and
``argmin``/``argmax`` take the first index on ties. So are its int32
fusion key ``i·32768 + j`` (unique below 32,768 keyframes) and its
loop-edge test ``j − i > 1`` (which compaction can blur).
"""

from __future__ import annotations

from typing import Tuple

import torch

from icpslam_tpu_torch.geometry import se3
from icpslam_tpu_torch.geometry.se3 import Pose
from icpslam_tpu_torch.graph import keyframes as kf
from icpslam_tpu_torch.graph import pose_graph as pg


def compose_covariance(Za: Pose, Sa: torch.Tensor, Zb: Pose, Sb: torch.Tensor) -> torch.Tensor:
    """Right-perturbation covariance of ``Za ∘ Zb``:
    ``Ad(Zb⁻¹) Σa Ad(Zb⁻¹)ᵀ + Σb``."""
    Ad = se3.adjoint(se3.inverse(Zb))
    return Ad @ Sa @ Ad.mT + Sb


def inverse_covariance(Z: Pose, S: torch.Tensor) -> torch.Tensor:
    """Right-perturbation covariance of ``Z⁻¹``: ``Ad(Z) Σ Ad(Z)ᵀ``."""
    Ad = se3.adjoint(Z)
    return Ad @ S @ Ad.mT


def select_victim(
    store: kf.KeyframeStore,
    edges: pg.EdgeSet,
    protect_recent: int = 8,
    loop_edge_penalty: float = 10.0,
) -> torch.Tensor:
    """Index (0-d int32) of the most redundant evictable keyframe. Call
    only on a full store with ``capacity > protect_recent + 1``."""
    K = store.capacity
    dev = store.stamp.device
    ids = torch.arange(K, device=dev)
    t = store.pose_graph.t
    d_prev = torch.linalg.norm(t - t[torch.clamp(ids - 1, min=0)], dim=-1)
    d_next = torch.linalg.norm(t[torch.clamp(ids + 1, max=K - 1)] - t, dim=-1)
    score = d_prev + d_next
    # loop edges carry non-local information: penalize evicting anchors
    w = (edges.valid & ((edges.j - edges.i) > 1)).to(score.dtype)
    ei = torch.where(edges.valid, edges.i, 0).long()
    ej = torch.where(edges.valid, edges.j, 0).long()
    deg = torch.zeros((K,), dtype=score.dtype, device=dev).index_add_(0, ei, w).index_add_(0, ej, w)
    score = score + loop_edge_penalty * deg
    protected = (ids == 0) | (ids >= store.count - protect_recent)
    score = torch.where(protected, torch.inf, score)
    return torch.clamp(torch.argmin(score), min=1).to(torch.int32)


def fuse_duplicate_edges(edges: pg.EdgeSet) -> pg.EdgeSet:
    """One pass of parallel-edge fusion: two valid edges with the same
    (i, j) become one, ``Ω' = Ω₁ + Ω₂`` and ``Z' = Z₁ ∘ exp((Ω')⁻¹ Ω₂ ξ)``
    with ``ξ = log(Z₁⁻¹ Z₂)``. A run of k duplicates fuses one pair per
    pass. The output is compacted to a live prefix."""
    dt = edges.rel_t.dtype
    dev = edges.i.device
    eye6 = torch.eye(6, dtype=dt, device=dev)
    big = torch.iinfo(torch.int32).max
    key = torch.where(edges.valid, edges.i * 32768 + edges.j, big)
    order = torch.argsort(key, stable=True)
    key_s = key[order]
    i_s, j_s = edges.i[order], edges.j[order]
    t_s, q_s = edges.rel_t[order], edges.rel_q[order]
    info_s, valid_s = edges.info[order], edges.valid[order]

    no = torch.zeros((1,), dtype=torch.bool, device=dev)
    prev_same = torch.cat([no, (key_s[1:] == key_s[:-1]) & (key_s[1:] != big)])
    # fuse only the second of each pair; a third in a run waits a pass
    second = prev_same & ~torch.cat([no, prev_same[:-1]])
    first = torch.cat([second[1:], no])

    # pair data aligned at the first rows (the partner is the next row)
    rel1 = Pose(t=t_s, q=q_s)
    rel2 = Pose(t=torch.roll(t_s, -1, 0), q=torch.roll(q_s, -1, 0))
    info2 = torch.roll(info_s, -1, 0)
    info_sum = info_s + info2
    xi = se3.se3_log(se3.relative(rel1, rel2))
    rhs = info2 @ xi[..., None]
    delta = torch.linalg.solve_ex(info_sum + 1e-6 * eye6, rhs)[0][..., 0]
    fused = se3.compose(rel1, se3.se3_exp(delta))
    f = first[:, None]
    new_t = torch.where(f, fused.t, t_s)
    new_q = torch.where(f, se3.normalize(fused).q, q_s)
    new_info = torch.where(f[..., None], info_sum, info_s)
    valid_out = valid_s & ~second

    # compact to a live prefix
    order2 = torch.argsort((~valid_out).to(torch.int32), stable=True)
    return pg.EdgeSet(
        i=i_s[order2], j=j_s[order2], rel_t=new_t[order2], rel_q=new_q[order2],
        info=new_info[order2], valid=valid_out[order2],
        count=valid_out.sum(dtype=torch.int32), overflow=edges.overflow,
    )


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` for a 0-d device index, without a host read."""
    return x.index_select(0, idx.reshape(1).long())[0]


def marginalize_keyframe(
    store: kf.KeyframeStore, edges: pg.EdgeSet, victim: torch.Tensor
) -> Tuple[kf.KeyframeStore, pg.EdgeSet]:
    """Remove keyframe ``victim`` (≥ 1, a 0-d tensor or int), re-home its
    edges to its predecessor with covariance-correct composition, fuse the
    parallel edges that makes, and compact both stores."""
    K, E = store.capacity, edges.capacity
    dt = store.pose_graph.t.dtype
    dev = store.stamp.device
    v = torch.as_tensor(victim, device=dev).to(torch.int32)
    p = v - 1
    eye6 = torch.eye(6, dtype=dt, device=dev)

    # the hop Z_pv: the strongest measured (p → v) edge (ICP over a wheel
    # twin), else the graph estimate with the victim's stored covariance
    # (zeros → a conservative 1e-2·I)
    tr_info = torch.diagonal(edges.info, dim1=-2, dim2=-1).sum(-1)
    seq_match = edges.valid & (edges.i == p) & (edges.j == v)
    any_seq = seq_match.any()
    k = torch.argmax(torch.where(seq_match, tr_info, -torch.inf))
    Z_est = se3.relative(
        Pose(_take(store.pose_graph.t, p), _take(store.pose_graph.q, p)),
        Pose(_take(store.pose_graph.t, v), _take(store.pose_graph.q, v)),
    )
    Z_pv = Pose(
        t=torch.where(any_seq, _take(edges.rel_t, k), Z_est.t),
        q=torch.where(any_seq, _take(edges.rel_q, k), Z_est.q),
    )
    Sig_meas = torch.linalg.inv_ex(_take(edges.info, k) + 1e-6 * eye6)[0]
    cov_v = _take(store.cov, v)
    Sig_fall = torch.where(torch.diagonal(cov_v).sum() > 0, cov_v, 1e-2 * eye6)
    Sig_pv = torch.where(any_seq, Sig_meas, Sig_fall)

    # re-home every edge on v, vectorized over all E
    rel = edges.rel()
    Sig_e = torch.linalg.inv_ex(edges.info + 1e-6 * eye6)[0]
    Zb = Pose(t=Z_pv.t.expand(E, 3), q=Z_pv.q.expand(E, 4))

    # case A: (v → x) becomes (p → x), Z' = Z_pv ∘ Z,
    # Σ' = Ad(Z⁻¹) Σ_pv Ad(Z⁻¹)ᵀ + Σ
    mA = edges.valid & (edges.i == v)
    ZA = se3.compose(Zb, rel)
    AdA = se3.adjoint(se3.inverse(rel))
    SigA = AdA @ Sig_pv @ AdA.mT + Sig_e

    # case B: (x → v) becomes (x → p), Z' = Z ∘ Z_pv⁻¹,
    # Σ' = Ad(Z_pv) (Σ + Σ_pv) Ad(Z_pv)ᵀ
    mB = edges.valid & (edges.j == v)
    inv_pv = se3.inverse(Z_pv)
    ZB = se3.compose(rel, Pose(t=inv_pv.t.expand(E, 3), q=inv_pv.q.expand(E, 4)))
    AdB = se3.adjoint(Z_pv)
    SigB = AdB @ (Sig_e + Sig_pv) @ AdB.mT

    a, b_ = mA[:, None], mB[:, None]
    new_t = torch.where(a, ZA.t, torch.where(b_, ZB.t, edges.rel_t))
    new_q = torch.where(a, ZA.q, torch.where(b_, ZB.q, edges.rel_q))
    touched = mA | mB
    new_sig = torch.where(a[..., None], SigA, torch.where(b_[..., None], SigB, Sig_e))
    new_info = torch.where(
        touched[:, None, None], torch.linalg.inv_ex(new_sig + 1e-8 * eye6)[0], edges.info
    )
    new_i = torch.where(mA, p, edges.i)
    new_j = torch.where(mB, p, edges.j)
    # the hop (p → v), and any wheel twin, became a self-edge: drop it
    valid = edges.valid & (new_i != new_j)
    # everything above the victim shifts down by one
    new_i = new_i - (new_i > v).to(torch.int32)
    new_j = new_j - (new_j > v).to(torch.int32)

    new_edges = fuse_duplicate_edges(pg.EdgeSet(
        i=new_i, j=new_j, rel_t=new_t, rel_q=new_q, info=new_info, valid=valid,
        count=valid.sum(dtype=torch.int32), overflow=edges.overflow,
    ))

    # compact the keyframe store: a shift-down gather keeps index order ==
    # temporal order
    ids = torch.arange(K, device=dev)
    src = torch.where(ids >= v, torch.clamp(ids + 1, max=K - 1), ids)

    def take(x):
        return x.index_select(0, src)

    new_store = kf.KeyframeStore(
        pose_odom=Pose(t=take(store.pose_odom.t), q=take(store.pose_odom.q)),
        pose_graph=Pose(t=take(store.pose_graph.t), q=take(store.pose_graph.q)),
        stamp=take(store.stamp),
        points=take(store.points),
        point_mask=take(store.point_mask),
        cov=take(store.cov),
        count=store.count - 1,
        evictions=store.evictions + 1,
    )
    return new_store, new_edges
