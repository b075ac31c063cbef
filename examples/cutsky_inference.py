"""Worked example 2: register a CUT-SKY catalog and infer on it.

The full survey-like workflow (reference `intro/CALA_intro.ipynb` territory):

  1. synthesize a cut-sky catalog — galaxies + randoms with (RA, DEC, Z,
     WEIGHT) columns on a sky cap and redshift shell (selection only: with
     --self-data below, the observation is the model's own synthetic draw,
     so the catalog's job is to define geometry + selection function);
  2. `run/register.py cutsky` — fits the bounding box, builds the radial
     selection and angular mask meshes, writes the register HDF5;
  3. `run/infer.py` — 3-phase inference campaign on the registered
     geometry (curved-sky RSD + light-cone machinery engaged).

    python examples/cutsky_inference.py            # ~10 min on CPU

Outputs in --save (default results/cutsky, gitignored): register HDF5 under
registered/, campaign dir with triangle.png / chains/ under results/.
"""
import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent


def synth_cutsky(out_dir: Path, n_data=20_000, n_random=100_000, seed=0):
    """Sky cap (RA in [150, 210], DEC in [-20, 20] deg), shell z in [0.8, 1.2],
    smooth radial selection peaked mid-shell. Randoms trace the selection;
    data is a thinned copy (clustering comes from --self-data, not here)."""
    rng = np.random.default_rng(seed)

    def draw(n):
        ra = rng.uniform(150.0, 210.0, n)
        # uniform on the sphere within the DEC band
        smin, smax = np.sin(np.deg2rad(-20.0)), np.sin(np.deg2rad(20.0))
        dec = np.rad2deg(np.arcsin(rng.uniform(smin, smax, n)))
        # triangular radial selection peaked at z = 1.0
        z = rng.triangular(0.8, 1.0, 1.2, n)
        w = np.ones(n)
        return dict(RA=ra, DEC=dec, Z=z, WEIGHT=w)

    out_dir.mkdir(parents=True, exist_ok=True)
    np.savez(out_dir / "data.npz", **draw(n_data))
    np.savez(out_dir / "random.npz", **draw(n_random))
    return out_dir / "data.npz", out_dir / "random.npz"


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--save", default="results/cutsky")
    ap.add_argument("--cell-budget", type=float, default=16**3,
                    help="total cells of the final mesh (16^3 quick)")
    ap.add_argument("--n-samples", type=int, default=8)
    ap.add_argument("--platform", default="cpu")
    args = ap.parse_args()

    save = Path(args.save).resolve()
    data, random = synth_cutsky(save / "catalogs")
    print(f"catalogs -> {data.parent}")

    env = None  # inherit; CLIs take --platform themselves
    run = lambda *cmd: subprocess.run(
        [sys.executable, *cmd], cwd=REPO, env=env, check=True)

    run("run/register.py", "cutsky",
        "--data", str(data), "--random", str(random),
        "--cell-budget", str(args.cell_budget),
        "--init-oversamp", "1.0", "--paint-oversamp", "1.0",
        "--out", str(save / "registered"), "--platform", args.platform)

    reg = sorted((save / "registered").glob("register_*.h5"))[-1]
    print(f"register -> {reg}")

    run("run/infer.py", "--register", str(reg),
        "--evolution", "kaiser", "--self-data",
        "--n-chains", "2", "--n-steps-field", "64", "--n-steps-full", "64",
        "--n-samples", str(args.n_samples), "--n-runs", "2", "--thinning", "2",
        "--save-root", str(save / "results"), "--platform", args.platform)

    out = sorted((save / "results").iterdir())[-1]
    print(f"\ncampaign -> {out}")
    print("see triangle.png (posterior corner), kptc.png (IC recovery),"
          " chains/ (HDF5)")


if __name__ == "__main__":
    main()
