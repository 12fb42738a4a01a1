"""Pose-graph (essential-graph) optimization over Sim(3).

Replaces the reference ``OptimizeEssentialGraph`` (reference src/Optimizer.cc:
2361: all keyframes as VertexSim3Expmap, edges = loop links + spanning tree +
high-covisibility (≥100) links, optimize(20), then divide translation by scale
to recover SE(3)) with a batched Gauss-Newton:

- Nodes: (K,) Sim3 world→kf as (s, R, t) with a validity/fixed mask.
- Edges: (E,) pairs with measured relative Sim3; residual
  r_e = log(S_meas⁻¹ ∘ S_i ∘ S_j⁻¹) ∈ R⁷.
- Jacobians by **automatic differentiation** of the residual wrt the two
  nodes' local tangent updates (vmapped per edge) — no hand-derived Sim3
  adjoints to get wrong; XLA fuses the whole linearization.
- Normal equations scatter into a dense (7K,7K) system; one solve per GN
  iteration (K ≤ a few hundred per map — small for one device).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from . import lie


def _edge_residual(xi_i, xi_j, s_i, R_i, t_i, s_j, R_j, t_j, m_s, m_R, m_t):
    """Residual of one edge at local updates (xi_i, xi_j) ∈ R7 applied on the
    RIGHT of each node: S ← S ∘ Exp(xi). Nodes are world→kf, so a right
    increment acts in the WORLD frame — required so that dof_mask's rotation
    components mean world-axis rotations (4DoF yaw = world gravity axis)."""
    ds_i, dR_i, dt_i = lie.sim3_exp(xi_i)
    ds_j, dR_j, dt_j = lie.sim3_exp(xi_j)
    si, Ri, ti = lie.sim3_compose(s_i, R_i, t_i, ds_i, dR_i, dt_i)
    sj, Rj, tj = lie.sim3_compose(s_j, R_j, t_j, ds_j, dR_j, dt_j)
    sji, Rji, tji = lie.sim3_inverse(sj, Rj, tj)
    s_ij, R_ij, t_ij = lie.sim3_compose(si, Ri, ti, sji, Rji, tji)
    # error = meas⁻¹ ∘ S_ij
    ms_i, mR_i, mt_i = lie.sim3_inverse(m_s, m_R, m_t)
    es, eR, et = lie.sim3_compose(ms_i, mR_i, mt_i, s_ij, R_ij, t_ij)
    return lie.sim3_log(es, eR, et)


def optimize_pose_graph(
    s: jax.Array, R: jax.Array, t: jax.Array, node_valid: jax.Array,
    fixed: jax.Array,
    edge_i: jax.Array, edge_j: jax.Array, edge_s: jax.Array, edge_R: jax.Array,
    edge_t: jax.Array, edge_valid: jax.Array, edge_weight: jax.Array,
    iters: int = 20, lam: float = 1e-6, dof_mask: jax.Array | None = None,
):
    """GN over the pose graph. Shapes: nodes (K,...), edges (E,...).

    dof_mask: optional (7,) bool over the sim3 tangent [w(3)|v(3)|sigma]
    selecting which update directions are free. This subsumes the
    reference's variants: all-True = OptimizeEssentialGraph Sim(3)
    (src/Optimizer.cc:2361); scale masked = the bFixScale stereo/RGBD mode;
    [0,0,yaw | v | 0] = OptimizeEssentialGraph4DoF for gravity-aligned
    inertial maps (src/Optimizer.cc:8367 — roll/pitch pinned by gravity,
    scale metric). Masked directions never move; the residual/Jacobian
    machinery is shared.

    Returns optimized (s, R, t).
    """
    K = s.shape[0]
    dtype = t.dtype
    zero7 = jnp.zeros(7, dtype)

    res_fn = _edge_residual
    jac_i = jax.vmap(jax.jacfwd(res_fn, argnums=0),
                     in_axes=(None, None, 0, 0, 0, 0, 0, 0, 0, 0, 0))
    jac_j = jax.vmap(jax.jacfwd(res_fn, argnums=1),
                     in_axes=(None, None, 0, 0, 0, 0, 0, 0, 0, 0, 0))
    res_v = jax.vmap(res_fn, in_axes=(None, None, 0, 0, 0, 0, 0, 0, 0, 0, 0))

    def gn_step(carry, _):
        s, R, t = carry
        si, Ri, ti = s[edge_i], R[edge_i], t[edge_i]
        sj, Rj, tj = s[edge_j], R[edge_j], t[edge_j]
        r = res_v(zero7, zero7, si, Ri, ti, sj, Rj, tj, edge_s, edge_R, edge_t)
        Ji = jac_i(zero7, zero7, si, Ri, ti, sj, Rj, tj, edge_s, edge_R, edge_t)
        Jj = jac_j(zero7, zero7, si, Ri, ti, sj, Rj, tj, edge_s, edge_R, edge_t)
        w = (edge_valid.astype(dtype) * edge_weight)

        H = jnp.zeros((K, 7, K, 7), dtype)
        b = jnp.zeros((K, 7), dtype)
        Hii = jnp.einsum("eai,e,eaj->eij", Ji, w, Ji)
        Hjj = jnp.einsum("eai,e,eaj->eij", Jj, w, Jj)
        Hij = jnp.einsum("eai,e,eaj->eij", Ji, w, Jj)
        H = H.at[edge_i, :, edge_i, :].add(Hii)
        H = H.at[edge_j, :, edge_j, :].add(Hjj)
        H = H.at[edge_i, :, edge_j, :].add(Hij)
        H = H.at[edge_j, :, edge_i, :].add(jnp.swapaxes(Hij, -1, -2))
        b = b.at[edge_i].add(-jnp.einsum("eai,e,ea->ei", Ji, w, r))
        b = b.at[edge_j].add(-jnp.einsum("eai,e,ea->ei", Jj, w, r))

        Hm = H.reshape(K * 7, K * 7)
        free = jnp.repeat(node_valid & ~fixed, 7)
        if dof_mask is not None:
            free = free & jnp.tile(jnp.asarray(dof_mask, bool), K)
        Hm = jnp.where(free[:, None] & free[None, :], Hm, 0.0)
        Hm = Hm + jnp.diag(jnp.where(free, lam, 1.0) + jnp.where(free, 0.0, 0.0))
        bv = jnp.where(free, b.reshape(-1), 0.0)
        dx = jnp.linalg.solve(Hm, bv).reshape(K, 7)

        ds, dR, dt = lie.sim3_exp(dx)
        sn, Rn, tn = lie.sim3_compose(s, R, t, ds, dR, dt)
        upd = (node_valid & ~fixed)
        s = jnp.where(upd, sn, s)
        R = jnp.where(upd[:, None, None], Rn, R)
        t = jnp.where(upd[:, None], tn, t)
        return (s, R, t), jnp.sum(r * r * w[:, None])

    (s, R, t), costs = jax.lax.scan(gn_step, (s, R, t), None, length=iters)
    return s, R, t, costs
