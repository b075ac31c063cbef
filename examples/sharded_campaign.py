"""Worked example 3: a MESH-DECOMPOSED (sharded) inference campaign.

Runs the production spatial decomposition without a multi-GPU machine: the
host platform is split into 8 virtual XLA CPU devices (the same recipe as
tests/conftest.py), arranged as a (chains x mesh) = (2 x 4)
`jax.sharding.Mesh`. `run/infer.py --spatial-mesh 4` then routes every 3-D
FFT through the pencil-FFT shard_map islands and the paint through the halo
island, with the chain axis data-parallel — the layout of an 8-GPU campaign
(`montecosmo_tpu/parallel/`, SURVEY §2.9).

    python examples/sharded_campaign.py            # ~10-15 min on CPU

On GPUs, drop the XLA_FLAGS override and the --platform cpu arguments, and
add --distributed for multi-process (jax.distributed) operation.
"""
import argparse
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--save", default="results/sharded")
    ap.add_argument("--spatial-mesh", type=int, default=4,
                    help="devices per chain (spatial decomposition)")
    ap.add_argument("--n-ptcl", type=int, default=16)
    args = ap.parse_args()
    save = Path(args.save).resolve()

    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8").strip()

    run = lambda *cmd: subprocess.run(
        [sys.executable, *cmd], cwd=REPO, env=env, check=True)

    run("run/register.py", "synthetic",
        # 32^3 final mesh (evolution mesh 56^3): every mesh extent must
        # DIVIDE the spatial mesh (56/4 = 14) or the pencil islands fall
        # back to layouts that trip an XLA:CPU fft-thunk assert at tiny
        # sizes (upstream bug).
        "--cell-budget", str(32**3), "--n-ptcl", str(args.n_ptcl),
        "--box-size", "320", "--init-oversamp", "1.0",
        "--paint-oversamp", "1.0",
        "--out", str(save / "registered"), "--platform", "cpu")
    reg = sorted((save / "registered").glob("register_*.h5"))[-1]

    run("run/infer.py", "--register", str(reg),
        "--evolution", "lpt", "--self-data",
        "--spatial-mesh", str(args.spatial_mesh), "--n-chains", "2",
        "--n-steps-field", "16", "--n-steps-full", "16",
        "--n-samples", "2", "--n-runs", "1", "--thinning", "2",
        "--save-root", str(save / "results"), "--platform", "cpu")

    out = sorted((save / "results").iterdir())[-1]
    print(f"\nsharded campaign -> {out}")


if __name__ == "__main__":
    main()
