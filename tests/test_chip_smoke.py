"""chip_smoke.py off the card: it refuses a CPU device, and its corpus,
scoring and last-line helpers work at a tiny size."""

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def _run(script_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, os.path.join(script_dir, "chip_smoke.py")],
        cwd=script_dir, env=env, capture_output=True, text=True, timeout=300,
    )


def _no_result(proc):
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        assert '"ok"' not in line


def test_refuses_cpu_device():
    proc = _run(ROOT)
    _no_result(proc)
    assert "needs an NVIDIA GPU" in proc.stderr


def test_fails_without_the_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    _no_result(_run(str(tmp_path)))


def test_last_line_shape():
    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    line = json.loads(chip_smoke.last_line([Dev()]))
    assert line == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


def test_corpus_and_scoring_tiny(tmp_path, monkeypatch):
    """The corpus writer and the scorer at a toy size: a perfect output
    (every truth pair, as M4 rows) scores 100/100."""
    from bella_tpu.eval.evaluate import load_truth, truth_pairs

    monkeypatch.setattr(chip_smoke, "COVERAGE", 2)
    reads, fofn, truth_path = chip_smoke.make_corpus(str(tmp_path), 30_000, seed=3)
    assert reads.num_reads == 10
    with open(fofn) as f:
        assert os.path.exists(f.read().strip())
    G = truth_pairs(load_truth(truth_path), min_overlap=chip_smoke.EVAL_CUTOFF)
    assert G
    out = tmp_path / "perfect.out"
    with open(out, "w") as f:
        for a, b in sorted(G):
            if a < b:
                f.write("\t".join([a, b, "1", "1", "5000", "n",
                                   "0", "1", "1", "0", "1", "1"]) + "\n")
    m = chip_smoke.score_output(str(out), truth_path)
    assert (m.recall, m.precision) == (100.0, 100.0)


def test_genome_cut_has_a_floor():
    with pytest.raises(SystemExit):
        chip_smoke.main(["--genome-len", "999999"])
