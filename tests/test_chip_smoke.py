"""chip_smoke.py on the CPU: it refuses to run without a GPU, and its
independent re-derivation of sampled CSV rows (tests/oracle.py + a host
searchsorted over the DB files) agrees with the classifier at a tiny size
and catches a wrong row."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("alone", [False, True])
def test_exits_nonzero_without_gpu(tmp_path, alone):
    script = os.path.join(REPO, "chip_smoke.py")
    if alone:  # a directory holding chip_smoke.py and nothing of the repo
        script = shutil.copy(script, tmp_path)
    r = _run(script, tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("smoke")
    db, reads, names, seqs = chip_smoke.make_workload(
        str(root), n_targets=5, glen=1500, n_reads=300
    )
    prof = ("--full", "--htsize", "1048573")
    chip_smoke.cli("db", "set-targets", db, "--rank", "species", *prof)
    chip_smoke.cli("db", "build", db, *prof)
    out = str(root / "plain")
    chip_smoke.cli("classify", "-D", db, "-O", reads, "-R", out)
    return db, out + ".csv", names, seqs


def test_sampled_rows_match_oracle(tiny_run):
    db, csv, names, seqs = tiny_run
    assert chip_smoke.check_sample(db, csv, names, seqs, 120) == 120


def test_sampled_check_catches_a_wrong_row(tiny_run, tmp_path):
    db, csv, names, seqs = tiny_run
    lines = open(csv, "rb").read().split(b"\n")
    # misassign a read that hit: gamma stays, the taxid column changes
    j = next(i for i, ln in enumerate(lines[1:-1], 1)
             if ln.split(b",")[2] != b"NA")
    f = lines[j].split(b",")
    f[2] = b"NA"
    lines[j] = b",".join(f)
    bad = tmp_path / "bad.csv"
    bad.write_bytes(b"\n".join(lines))
    with pytest.raises(AssertionError, match=f"read {j - 1}:"):
        chip_smoke.check_sample(db, str(bad), names, seqs, len(names))
