"""Compare sharded vs single-device BA normal equations on identical state."""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
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
    lam = jnp.asarray(1e-4, jnp.float32)
    huber = float(ba_ops.CHI2_MONO) ** 0.5

    # ---- single-device assembly (mirror _gn_step_from_lin up to the solve)
    prob = ba_ops.BAProblem(
        R=jnp.asarray(R0), t=jnp.asarray(t0), pts=jnp.asarray(pts0),
        obs_kf=jnp.asarray(obs_kf), obs_mp=jnp.asarray(obs_mp),
        obs_uv=jnp.asarray(obs_uv),
        obs_inv_sigma2=jnp.ones(O, jnp.float32),
        obs_valid=jnp.ones(O, bool), fixed_pose=jnp.asarray(fixed),
        obs_ur=jnp.full(O, -1.0, jnp.float32), bf=jnp.asarray(0.0, jnp.float32))
    w_mask = prob.obs_valid.astype(jnp.float32)
    chi2, w, Jpose, Jpt, r = ba_ops._linearize(
        prob, prob.pts, prob.R, prob.t, w_mask, 0, jnp.asarray(K_CAM),
        jnp.asarray(huber, jnp.float32))
    K = n_kf; P = n_pts
    dtype = jnp.float32
    App = jnp.einsum("oik,oi,oil->okl", Jpose, w, Jpose)
    Hpp = jnp.zeros((K, 6, 6), dtype).at[prob.obs_kf].add(App)
    bp = jnp.zeros((K, 6), dtype).at[prob.obs_kf].add(
        jnp.einsum("oik,oi,oi->ok", Jpose, w, r))
    All = jnp.einsum("oik,oi,oil->okl", Jpt, w, Jpt)
    Hll = jnp.zeros((P, 3, 3), dtype).at[prob.obs_mp].add(All)
    bl = jnp.zeros((P, 3), dtype).at[prob.obs_mp].add(
        jnp.einsum("oik,oi,oi->ok", Jpt, w, r))
    Bo = jnp.einsum("oik,oi,oil->okl", Jpose, w, Jpt)
    B = jnp.zeros((P, K, 6, 3), dtype).at[prob.obs_mp, prob.obs_kf].add(Bo)
    diagl = jnp.einsum("pii->pi", Hll)
    Hll_d = Hll + jax.vmap(jnp.diag)(lam * diagl + 1e-6)
    Hll_inv = ba_ops.inv3(Hll_d)
    C = jnp.einsum("pkil,plm->pkim", B, Hll_inv)
    S2 = jnp.einsum("pkim,pqjm->kiqj", C, B)
    S_ref = -S2
    S_ref = S_ref.at[jnp.arange(K), :, jnp.arange(K), :].add(Hpp)
    S_ref = S_ref.reshape(K * 6, K * 6)
    bs_ref = (bp - jnp.einsum("pkim,pm->ki", C, bl)).reshape(-1)

    # ---- sharded assembly
    n_pts_pad, o_per, local_mp, obs_valid_sh, outs = \
        sharded_ba.partition_by_landmark(obs_mp, n_pts, n_dev,
                                         {"kf": obs_kf, "uv": obs_uv})
    pts_pad = np.zeros((n_pts_pad, 3), np.float32)
    pts_pad[: n_pts] = pts0
    w_sh = obs_valid_sh.astype(np.float32)
    per = n_pts_pad // n_dev
    o_sh = o_per

    S_acc = np.zeros((K * 6, K * 6), np.float32)
    bs_acc = np.zeros(K * 6, np.float32)
    for s in range(n_dev):
        sl = slice(s * o_sh, (s + 1) * o_sh)
        psl = slice(s * per, (s + 1) * per)
        S_part, bs_part, _, _, _ = sharded_ba._local_schur_pieces(
            jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(pts_pad[psl]),
            jnp.asarray(outs["kf"][sl]), jnp.asarray(local_mp[sl]),
            jnp.asarray(outs["uv"][sl]), jnp.asarray(w_sh[sl]),
            jnp.asarray(K_CAM), K, huber, lam, 0)
        S_acc += np.asarray(S_part)
        bs_acc += np.asarray(bs_part)

    S_ref = np.asarray(S_ref); bs_ref = np.asarray(bs_ref)
    dS = np.abs(S_acc - S_ref)
    print("S scale:", np.abs(S_ref).max(), " max |dS|:", dS.max(),
          " rel:", dS.max() / np.abs(S_ref).max())
    print("bs scale:", np.abs(bs_ref).max(), " max |dbs|:",
          np.abs(bs_acc - bs_ref).max())
    ij = np.unravel_index(np.argmax(dS), dS.shape)
    print("worst entry at", ij, S_ref[ij], S_acc[ij])

    # ---- now the damped solve comparison on the SAME S_ref
    for name, S, bs in (("ref", S_ref, bs_ref), ("sh", S_acc, bs_acc)):
        Sm = S + np.diag(lam * np.diag(S) + 1e-6)
        free = np.repeat(~fixed, 6)
        Sm = np.where(free[:, None] & free[None, :], Sm, 0.0)
        Sm = Sm + np.diag(np.where(free, 0.0, 1.0))
        bsf = np.where(free, bs, 0.0)
        dx64 = np.linalg.solve(Sm.astype(np.float64), bsf.astype(np.float64))
        dx32 = np.asarray(jnp.linalg.solve(jnp.asarray(Sm), jnp.asarray(bsf)))
        import scipy.linalg as sla
        try:
            cho = sla.cho_factor(Sm.astype(np.float32))
            dxc = sla.cho_solve(cho, bsf.astype(np.float32))
        except Exception as e:
            dxc = None
            print(name, "cho failed:", e)
        print(name, "|dx64|max:", np.abs(dx64).max(),
              "|dx32-dx64|max:", np.abs(dx32 - dx64).max(),
              "" if dxc is None else f"|dxcho-dx64|max: {np.abs(dxc-dx64).max()}")
        print(name, "cond(Sm) est:", np.linalg.cond(Sm.astype(np.float64)))


if __name__ == "__main__":
    main()
