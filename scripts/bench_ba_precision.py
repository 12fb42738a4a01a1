"""A/B the precision of the Schur contractions in ops/ba.py on the GPU.

The fixtures of chip_smoke.py's phase 3 (chip_smoke.BA_BOUNDS), each solved
with local BA (the two-phase 5+10 schedule):
- ``bench_K16/64/256``: bench._make_ba_problem, P=4096, O=16384 (random
  observations, so at K>=64 the poses are weakly determined);
- ``loop_K256``: chip_smoke.loop_ba_problem, 256 keyframes that all see
  1024 points (well determined).
For ORBSLAM3_BA_SCHUR_PRECISION in {highest, high} (high is TF32 on an NVIDIA
GPU), a child process solves every fixture on the default device and times
10-iteration solves. One more child solves them on the CPU backend, whose
float32 dot ignores the precision setting, twice: in the given observation
order and with the observations permuted, which shows how far summation
order alone moves each fixture's solution. Each GPU run is judged by its
chi2 and pose-translation difference from the CPU, beside the GPU's own
difference between two identical solves (its scatter-adds run in a new
order each time). Rows print as each child ends.

    python scripts/bench_ba_precision.py

The children run one after another and the parent never imports JAX, so one
process at a time holds the card.
"""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import functools, json, sys, time
import numpy as np
sys.path.insert(0, %(repo)r)
import jax
import jax.numpy as jnp
import chip_smoke
from orbslam3_jax.ops import ba as ba_ops

out = {"platform": jax.devices()[0].platform,
       "precision": str(ba_ops.SCHUR_PRECISION)}
solve = jax.jit(functools.partial(ba_ops.local_ba, cam_type=0,
                                  chi2_th=ba_ops.CHI2_MONO),
                static_argnames=("iters1", "iters2"))
for name in chip_smoke.BA_BOUNDS:
    prob, K = jax.device_put(chip_smoke.ba_fixture(name))
    a = jax.block_until_ready(solve(prob, K))
    if out["platform"] == "cpu":
        perm = np.random.default_rng(1).permutation(prob.obs_kf.shape[0])
        b = solve(prob._replace(**{f: getattr(prob, f)[perm] for f in (
            "obs_kf", "obs_mp", "obs_uv", "obs_inv_sigma2", "obs_valid",
            "obs_ur")}), K)
    else:
        b = solve(prob, K)
    b = jax.block_until_ready(b)
    r = {"chi2": float(a.chi2), "t": np.asarray(a.t).tolist(),
         "rerun_dt": float(np.abs(np.asarray(a.t) - np.asarray(b.t)).max())}
    if out["platform"] != "cpu":
        jax.block_until_ready(solve(prob, K, iters1=10, iters2=0))
        t0 = time.perf_counter()
        for _ in range(3):
            res = solve(prob, K, iters1=10, iters2=0)
        jax.block_until_ready(res)
        r["iters_per_s"] = 30 / (time.perf_counter() - t0)
    out[name] = r
print("RESULT " + json.dumps(out))
"""


def run(prec, platform=None):
    env = dict(os.environ, ORBSLAM3_BA_SCHUR_PRECISION=prec)
    if platform:
        env["JAX_PLATFORMS"] = platform
    p = subprocess.run([sys.executable, "-c", CHILD % {"repo": REPO}],
                       capture_output=True, text=True, env=env, timeout=1200)
    for line in p.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[7:])
    print(p.stdout[-2000:], p.stderr[-2000:])
    raise RuntimeError(f"no result for {prec} on {platform or 'default'}")


def main():
    cpu = run("highest", "cpu")
    fixtures = [k for k, v in cpu.items() if isinstance(v, dict)]
    print(f"{'fixture':>10} {'precision':>9} {'iters/s':>9} "
          f"{'chi2 rel-diff':>14} {'max|dt| m':>10} {'rerun |dt| m':>13}",
          flush=True)
    for name in fixtures:
        print(f"{name:>10} {'cpu':>9} {'':>9} {'':>14} {'':>10} "
              f"{cpu[name]['rerun_dt']:>13.3e}  (permuted observation order)",
              flush=True)
    for prec in ("highest", "high"):
        res = run(prec)
        for name in fixtures:
            g, c = res[name], cpu[name]
            rel = abs(g["chi2"] - c["chi2"]) / abs(c["chi2"])
            dt = max(abs(x - y) for gr, cr in zip(g["t"], c["t"])
                     for x, y in zip(gr, cr))
            print(f"{name:>10} {prec:>9} "
                  f"{g.get('iters_per_s', float('nan')):>9.1f} {rel:>14.3e} "
                  f"{dt:>10.3e} {g['rerun_dt']:>13.3e}", flush=True)


if __name__ == "__main__":
    main()
