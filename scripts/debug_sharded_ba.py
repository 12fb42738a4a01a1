"""Debug the 256-KF sharded-BA parity failure (VERDICT r3 Weak #3).

Runs the failing fixture with per-iteration cost traces on both solvers.
Run: JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
     python scripts/debug_sharded_ba.py
"""
import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from orbslam3_jax.ops import ba as ba_ops, lie
from orbslam3_jax.parallel import sharded_ba

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests"))
from test_sharded_ba import make_problem, K_CAM  # noqa: E402


def main():
    n_dev = len(jax.devices())
    print("devices:", n_dev)
    n_kf, n_pts = 256, 1024
    R_gt, t_gt, pts_gt, obs_kf, obs_mp, obs_uv = make_problem(
        n_kf=n_kf, n_pts=n_pts, seed=3)
    rng = np.random.default_rng(4)
    R0 = R_gt.copy(); t0 = t_gt.copy()
    for k in range(2, n_kf):
        dR = np.asarray(lie.so3_exp(jnp.asarray(
            rng.normal(0, 0.01, 3).astype(np.float32))))
        R0[k] = dR @ R_gt[k]
        t0[k] = t_gt[k] + rng.normal(0, 0.03, 3)
    pts0 = (pts_gt + rng.normal(0, 0.03, pts_gt.shape)).astype(np.float32)
    fixed = np.zeros(n_kf, bool); fixed[:2] = True
    O = len(obs_kf)
    it1, it2 = 4, 4

    prob = ba_ops.BAProblem(
        R=jnp.asarray(R0), t=jnp.asarray(t0), pts=jnp.asarray(pts0),
        obs_kf=jnp.asarray(obs_kf), obs_mp=jnp.asarray(obs_mp),
        obs_uv=jnp.asarray(obs_uv),
        obs_inv_sigma2=jnp.ones(O, jnp.float32),
        obs_valid=jnp.ones(O, bool), fixed_pose=jnp.asarray(fixed),
        obs_ur=jnp.full(O, -1.0, jnp.float32), bf=jnp.asarray(0.0, jnp.float32))
    ref = ba_ops.local_ba(prob, jnp.asarray(K_CAM), iters1=it1, iters2=it2)
    print("ref err:", np.abs(np.asarray(ref.t) - t_gt).max(),
          "inl:", int(np.asarray(ref.n_inlier)))

    mesh = sharded_ba.make_mesh()
    n_pts_pad, o_per, local_mp, obs_valid_sh, outs = \
        sharded_ba.partition_by_landmark(obs_mp, n_pts, n_dev,
                                         {"kf": obs_kf, "uv": obs_uv})
    pts_pad = np.zeros((n_pts_pad, 3), np.float32)
    pts_pad[: n_pts] = pts0
    w = obs_valid_sh.astype(np.float32)

    # per-iteration: reuse the single-step kernel to trace costs
    step = sharded_ba.make_sharded_ba_step(mesh, n_kf)
    R, t, pts = jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(pts_pad)

    def host_cost(Rh, th, ph):
        e = 0.0
        Rh = np.asarray(Rh); th = np.asarray(th); ph = np.asarray(ph)[:n_pts]
        pc = np.einsum("kij,pj->kpi", Rh, ph) + th[:, None]
        uv = np.stack([458 * pc[..., 0] / pc[..., 2] + 376,
                       458 * pc[..., 1] / pc[..., 2] + 240], -1)
        return float(np.sum((uv[obs_kf, obs_mp] - obs_uv) ** 2))

    lam = jnp.asarray(1e-4, jnp.float32)
    for i in range(it1 + it2):
        R, t, pts = step(R, t, jnp.asarray(fixed), pts,
                         jnp.asarray(outs["kf"]), jnp.asarray(local_mp),
                         jnp.asarray(outs["uv"]), jnp.asarray(w),
                         jnp.asarray(K_CAM), lam)
        print(f"gn-step it{i}: cost={host_cost(R, t, pts):.1f} "
              f"t_err={np.abs(np.asarray(t) - t_gt).max():.4f}")

    solver = sharded_ba.make_sharded_ba_solver(mesh, n_kf,
                                               iters1=it1, iters2=it2)
    R2, t2, pts2, inl = solver(
        jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(fixed),
        jnp.asarray(pts_pad), jnp.asarray(outs["kf"]), jnp.asarray(local_mp),
        jnp.asarray(outs["uv"]), jnp.asarray(w), jnp.asarray(K_CAM))
    print("solver err:", np.abs(np.asarray(t2) - t_gt).max(),
          "inl:", int(np.asarray(inl).sum()), "/", O,
          "cost:", host_cost(R2, t2, pts2))
    # where is the error? per-kf error profile
    e = np.linalg.norm(np.asarray(t2) - t_gt, axis=1)
    print("worst kfs:", np.argsort(-e)[:10], e[np.argsort(-e)[:10]])


if __name__ == "__main__":
    main()
