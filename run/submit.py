"""Job submission for inference campaigns: SLURM or a local queue.

The reference ships a commented-out desipipe/NERSC TaskManager block
(`/root/reference/run/infer.py:20-41`) for submitting `infer` as SLURM GPU
jobs.  Two launchers:

  slurm : generate + `sbatch` a job script (any GPU partition); multi-node
          jobs start one process per node and rely on
          `run/infer.py --distributed` (jax.distributed) to form the cluster.
  local : append to a serialized local queue (one job at a time: a JAX
          process reserves most of a card's memory, so two jobs on one card
          fail).

Script generation is pure text (hermetically tested); submission shells out
only when the scheduler binary exists.

Usage:
  python run/submit.py --scheduler slurm --time 04:00:00 --nodes 1 -- \
      python run/infer.py --register registered/reg.h5 --self-data
"""
import argparse
import os
import shlex
import shutil
import subprocess
import sys
from datetime import datetime
from pathlib import Path


def make_slurm_script(cmd, *, job_name="montecosmo", time="04:00:00",
                      nodes=1, account=None, partition=None, qos=None,
                      constraint=None, gpus_per_node=None, out_dir="outs",
                      env_setup="", workdir=None):
    """Render an sbatch script for `cmd` (list of argv tokens).

    Multi-node jobs launch one task per node via srun; run/infer.py
    --distributed forms the jax.distributed cluster from the SLURM env
    (parallel/cluster.py reads SLURM_* variables).
    """
    cmd = " ".join(shlex.quote(c) for c in cmd)
    lines = [
        "#!/bin/bash",
        f"#SBATCH --job-name={job_name}",
        f"#SBATCH --time={time}",
        f"#SBATCH --nodes={nodes}",
        "#SBATCH --ntasks-per-node=1",
        f"#SBATCH --output={out_dir}/slurm-%j.out",
        f"#SBATCH --error={out_dir}/slurm-%j.err",
    ]
    for flag, val in (("account", account), ("partition", partition),
                      ("qos", qos), ("constraint", constraint),
                      ("gpus-per-node", gpus_per_node)):
        if val is not None:
            lines.append(f"#SBATCH --{flag}={val}")
    lines.append("")
    if workdir:
        lines.append(f"cd {shlex.quote(str(workdir))}")
    if env_setup:
        lines.append(env_setup)
    launcher = "srun " if nodes > 1 else ""
    lines += [f"{launcher}{cmd}", ""]
    return "\n".join(lines)


def submit_local(cmd, queue_file):
    """Append to the serialized local queue (consumed by `run_local_queue`).
    One line per job; `#` comments and blank lines are skipped."""
    queue_file = Path(queue_file)
    queue_file.parent.mkdir(parents=True, exist_ok=True)
    with open(queue_file, "a") as f:
        f.write(" ".join(shlex.quote(c) for c in cmd) + "\n")
    return queue_file


def run_local_queue(queue_file, log_dir="outs"):
    """Run queued jobs one at a time (pop from the head; crash-safe: a job
    is removed only after it exits)."""
    queue_file, log_dir = Path(queue_file), Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    rcs = []
    while True:
        lines = [l for l in queue_file.read_text().splitlines()
                 if l.strip() and not l.startswith("#")] \
            if queue_file.exists() else []
        if not lines:
            return rcs
        job = lines[0]
        stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
        log = log_dir / f"local-{stamp}-{len(rcs)}.out"
        with open(log, "w") as f:
            rc = subprocess.call(job, shell=True, stdout=f,
                                 stderr=subprocess.STDOUT)
        rcs.append((job, rc, str(log)))
        rest = queue_file.read_text().splitlines()
        rest.remove(job)
        queue_file.write_text("\n".join(rest) + ("\n" if rest else ""))


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scheduler", default="slurm",
                    choices=["slurm", "local"])
    ap.add_argument("--job-name", default="montecosmo")
    ap.add_argument("--time", default="04:00:00")
    ap.add_argument("--nodes", type=int, default=1)
    ap.add_argument("--account", default=None)
    ap.add_argument("--partition", default=None)
    ap.add_argument("--qos", default=None)
    ap.add_argument("--constraint", default=None)
    ap.add_argument("--gpus-per-node", default=None)
    ap.add_argument("--env-setup", default="",
                    help="shell line(s) run before the command (module "
                         "loads, venv activation)")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--queue-file", default="outs/local_queue.txt")
    ap.add_argument("--dry-run", action="store_true",
                    help="print the script/command without submitting")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="the job command, after `--`")
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    if not cmd:
        ap.error("no job command given (pass it after `--`)")

    if args.scheduler == "slurm":
        script = make_slurm_script(
            cmd, job_name=args.job_name, time=args.time, nodes=args.nodes,
            account=args.account, partition=args.partition, qos=args.qos,
            constraint=args.constraint, gpus_per_node=args.gpus_per_node,
            env_setup=args.env_setup, workdir=args.workdir)
        if args.dry_run:
            print(script)
            return 0
        Path("outs").mkdir(exist_ok=True)
        path = Path("outs") / f"{args.job_name}.sbatch"
        path.write_text(script)
        if shutil.which("sbatch") is None:
            print(f"sbatch not found; script written to {path}",
                  file=sys.stderr)
            return 1
        return subprocess.call(["sbatch", str(path)])

    qf = submit_local(cmd, args.queue_file)
    print(f"queued in {qf}")
    if not args.dry_run and os.environ.get("MONTECOSMO_RUN_QUEUE"):
        for job, rc, log in run_local_queue(qf):
            print(f"rc={rc} {job} -> {log}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
