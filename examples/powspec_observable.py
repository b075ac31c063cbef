"""Worked example 4: POWER-SPECTRUM observable inference.

Beyond-reference capability (the reference leaves this as a TODO,
`/root/reference/montecosmo/model.py`): instead of conditioning on the
full count mesh, the likelihood compresses the observation to multipole
band powers with a discrete-grid Grieb covariance — the classic
"field-level vs P(l)" comparison in one framework.

    python examples/powspec_observable.py          # ~10 min on CPU

The campaign infers (Omega_m, sigma8, b1, ...) from the multipoles of a
synthetic observation; compare the widths of triangle.png against the
field-level campaign of examples/quickstart.py at the same scale.
"""
import argparse
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--save", default="results/powspec")
    ap.add_argument("--n-ptcl", type=int, default=16)
    args = ap.parse_args()
    save = Path(args.save).resolve()

    run = lambda *cmd: subprocess.run(
        [sys.executable, *cmd], cwd=REPO, check=True)

    run("run/register.py", "synthetic",
        "--cell-budget", str(16**3), "--n-ptcl", str(args.n_ptcl),
        "--box-size", "320", "--init-oversamp", "1.0",
        "--paint-oversamp", "1.0",
        "--out", str(save / "registered"), "--platform", "cpu")
    reg = sorted((save / "registered").glob("register_*.h5"))[-1]

    # powspec observable: the white-noise field is NOT a latent to sample
    # (the band powers constrain only the scalars), so the field phases are
    # conditioned alongside the usual nuisance blocks via --obs
    run("run/infer.py", "--register", str(reg),
        "--evolution", "lpt", "--self-data", "--observable", "powspec",
        "--n-chains", "2", "--n-steps-field", "32", "--n-steps-full", "64",
        "--n-samples", "8", "--n-runs", "2", "--thinning", "2",
        "--save-root", str(save / "results"), "--platform", "cpu")

    out = sorted((save / "results").iterdir())[-1]
    print(f"\npowspec campaign -> {out}")


if __name__ == "__main__":
    main()
