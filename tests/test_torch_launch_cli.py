"""The port's dry-run CLI (``python -m repro_torch.launch.dryrun``), its
sweep (``launch/sweep.py``) and the pipeline dry run (``launch/
dryrun_pp.py``), on the CPU: the CLI writes JAX's file name and keys, the
sweep resumes and leaves ``.err`` files, ``dryrun_pp`` hands off each
microbatch.  (The cells' specs against JAX's: ``tests/test_torch_
launch.py``.)"""
import json
import os
import subprocess
import sys

from repro_torch.launch import dryrun_pp, sweep
from repro_torch.launch.dryrun import MESH_NAMES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cli_writes_jax_named_record(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "mamba2-370m", "--shape", "long_500k", "--mesh", "pod", "--smoke",
         "--out", str(tmp_path)], capture_output=True, text=True, env=env,
        cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "status=OK" in r.stdout
    rec = json.load(open(tmp_path / "mamba2-370m__long_500k__pod16x16.json"))
    for key in ("status", "kind", "seq", "batch", "profile",
                "memory_analysis", "hlo_cost", "collectives_static",
                "model_flops", "n_params", "n_active_params", "n_devices",
                "lower_s", "compile_s"):
        assert key in rec, key
    assert set(rec["memory_analysis"]) == {
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes"}
    assert set(rec["hlo_cost"]) == {"flops", "hbm_bytes", "collectives",
                                    "collective_bytes_total"}
    assert rec["n_devices"] == 256 and rec["state_over_data"] is True
    assert rec["hlo_cost"]["flops"] > 0
    assert MESH_NAMES[False] == "pod16x16"


def test_sweep_resumes_and_records_failures(tmp_path, monkeypatch):
    """Two cells: glm4-9b long_500k (a SKIP record) and an arch that does
    not exist (an .err); a second sweep runs only the failed one again."""
    monkeypatch.setenv("PYTHONPATH", os.path.join(REPO, "src"))
    args = ["--mesh", "pod", "--archs", "glm4-9b", "no-such-arch",
            "--shapes", "long_500k", "--out", str(tmp_path),
            "--timeout", "300"]
    sweep.main(args)
    done = tmp_path / "glm4-9b__long_500k__pod16x16.json"
    err = tmp_path / "no-such-arch__long_500k__pod16x16.json.err"
    assert json.load(open(done))["status"] == "SKIP"
    assert err.exists() and "unknown arch" in err.read_text()
    stamp = done.stat().st_mtime_ns
    sweep.main(args)
    assert done.stat().st_mtime_ns == stamp        # resumed: not rerun
    log = (tmp_path / "sweep.log").read_text().split("\n")
    assert [line.split()[:4] for line in log if line] == [
        ["glm4-9b", "long_500k", "pod", "OK"],
        ["no-such-arch", "long_500k", "pod", "FAILED"],
        ["no-such-arch", "long_500k", "pod", "FAILED"]]


def test_dryrun_pp_hands_off_each_microbatch(tmp_path):
    rec = dryrun_pp.run(str(tmp_path))
    cp = rec["hlo_cost"]["collectives"]["collective-permute"]
    # M (S - 1) = 8 hand-offs of a 32 x 4096 x 1024 bf16 microbatch (JAX's
    # HLO ppermutes once a tick, M + S - 1 = 9 times)
    assert cp["count"] == 8
    assert cp["operand_bytes"] == 8 * 32 * 4096 * 1024 * 2
    assert rec["hlo_cost"]["flops"] > 0
    assert (tmp_path / "pipeline__train_4k__pod2x16x16.json").exists()
