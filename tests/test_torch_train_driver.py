"""The port's training CLI end to end on the CPU (``--device cpu``), as
``test_train_driver.py`` drives the JAX package's: it trains, checkpoints,
survives a simulated failure, resumes from the checkpoint, and writes
coded checkpoint targets."""

import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

SRC = str(pathlib.Path(__file__).parents[1] / "src")


def _run(args, timeout=600):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           "--device", "cpu"] + args,
                          env=env, capture_output=True, text=True, timeout=timeout)


def test_train_failure_and_resume(tmp_path):
    base = ["--arch", "internlm2-1.8b", "--reduced", "--steps", "12",
            "--batch", "2", "--seq", "32", "--ckpt-every", "5",
            "--ckpt-dir", str(tmp_path)]
    # the first run dies at step 8 (after the step-5 checkpoint)
    p1 = _run(base + ["--simulate-failure", "8"])
    assert p1.returncode == 17, p1.stdout + p1.stderr
    assert "fresh start" in p1.stdout and "SIMULATED FAILURE at step 8" in p1.stdout
    assert "[train] step     0 loss" in p1.stdout
    # the second resumes from step 5 and completes
    p2 = _run(base)
    assert p2.returncode == 0, p2.stdout + p2.stderr
    assert "resumed from step 5" in p2.stdout
    assert "[train] step    11 loss" in p2.stdout and "gnorm" in p2.stdout
    assert "done: 12 steps" in p2.stdout


def test_train_with_coded_checkpoint(tmp_path):
    p = _run(["--arch", "internlm2-1.8b", "--reduced", "--steps", "6",
              "--batch", "2", "--seq", "32", "--ckpt-every", "5",
              "--coded-ckpt", "--ckpt-dir", str(tmp_path)])
    assert p.returncode == 0, p.stdout + p.stderr
    coded = list(pathlib.Path(tmp_path).glob("*/coded_*/target_*.npz"))
    assert len(coded) >= 24, "coded shards written"


def test_elastic_names_the_roadmap(tmp_path):
    p = _run(["--arch", "internlm2-1.8b", "--reduced", "--elastic",
              "--ckpt-dir", str(tmp_path)])
    assert p.returncode != 0 and "ROADMAP queue 1, item 8" in p.stderr
