"""Job-submission layer (run/submit.py) — hermetic script-generation tests.

Parity: the reference's commented-out desipipe/NERSC TaskManager block
(/root/reference/run/infer.py:20-41); here SLURM + a local serialized queue.
"""
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "run"))

import submit  # noqa: E402


def test_slurm_script_single_node():
    s = submit.make_slurm_script(
        ["python", "run/infer.py", "--register", "r.h5", "--self-data"],
        job_name="ess64", time="02:00:00", nodes=1, qos="regular",
        constraint="gpu", env_setup="source env/bin/activate")
    assert "#SBATCH --job-name=ess64" in s
    assert "#SBATCH --time=02:00:00" in s
    assert "#SBATCH --qos=regular" in s
    assert "#SBATCH --constraint=gpu" in s
    assert "source env/bin/activate" in s
    # single node: no srun prefix
    assert "\npython run/infer.py --register r.h5 --self-data\n" in s
    assert "--account" not in s


def test_slurm_script_multinode_uses_srun_and_distributed_fits():
    s = submit.make_slurm_script(
        ["python", "run/infer.py", "--distributed"], nodes=4)
    assert "#SBATCH --nodes=4" in s
    assert "srun python run/infer.py --distributed" in s


def test_local_queue_roundtrip(tmp_path):
    qf = tmp_path / "q.txt"
    submit.submit_local(["echo", "a b"], qf)
    submit.submit_local(["false"], qf)
    rcs = submit.run_local_queue(qf, log_dir=tmp_path / "logs")
    assert [rc for _, rc, _ in rcs] == [0, 1]
    assert qf.read_text() == ""
    log0 = Path(rcs[0][2]).read_text()
    assert "a b" in log0


def test_cli_dry_run():
    out = subprocess.run(
        [sys.executable, str(Path(submit.__file__)), "--scheduler", "slurm",
         "--dry-run", "--", "python", "-c", "pass"],
        capture_output=True, text=True)
    assert out.returncode == 0
    assert "#SBATCH" in out.stdout
