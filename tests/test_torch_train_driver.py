"""The port's training CLI end to end on the CPU (``--device cpu``), as
``test_train_driver.py`` drives the JAX package's: it trains, checkpoints,
survives a simulated failure, resumes from the checkpoint, and writes
coded checkpoint targets; and on a mesh of gloo ranks, restarts with
``--elastic`` on fewer ranks."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import repro_torch.configs as configs  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.training.checkpoint import save_checkpoint  # noqa: E402
from repro_torch.training.optimizer import AdamW  # noqa: E402

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


LOSS_ATOL = 2e-4  # the printed losses carry 4 decimals
_LOSS = re.compile(r"\[train\] step +(\d+) loss +([0-9.]+)")


def _losses(stdout: str) -> dict:
    return {int(step): float(loss) for step, loss in _LOSS.findall(stdout)}


def test_elastic_restart_on_fewer_ranks(tmp_path):
    """4 gloo ranks on {data 2, model 2} die at step 8; ``--elastic`` on 2
    ranks resumes from the step-5 checkpoint on {data 1, model 2}.  From
    one step-0 checkpoint, the losses match an uninterrupted one-process
    run, and step 0 and the last step the JAX CLI's on 4 host devices."""
    base = ["--arch", "internlm2-1.8b", "--reduced", "--steps", "12",
            "--batch", "2", "--seq", "32", "--ckpt-every", "5"]
    # every run starts from one step-0 checkpoint (the packages' inits
    # draw from different generators; the checkpoint format is shared)
    model = build(configs.get("internlm2-1.8b").reduced(), "cpu")
    params = model.init(0)
    for run in ("mesh", "one", "jax"):
        save_checkpoint(tmp_path / run / model.cfg.name, 0, params, AdamW().init(params))
    ckpt = ["--ckpt-dir", str(tmp_path / "mesh")]
    p1 = _run(base + ckpt + ["--nproc", "4", "--simulate-failure", "8"])
    assert p1.returncode == 17, p1.stdout + p1.stderr
    assert "[train] mesh {'data': 2, 'model': 2}" in p1.stdout
    assert "resumed from step 0" in p1.stdout and "SIMULATED FAILURE at step 8" in p1.stdout
    p2 = _run(base + ckpt + ["--nproc", "2", "--elastic", "--model-parallel", "2"])
    assert p2.returncode == 0, p2.stdout + p2.stderr
    assert "[train] mesh {'data': 1, 'model': 2}" in p2.stdout
    assert "resumed from step 5" in p2.stdout and "done: 12 steps" in p2.stdout
    whole = _losses(_run(base + ["--ckpt-dir", str(tmp_path / "one")]).stdout)
    got = {**_losses(p1.stdout), **_losses(p2.stdout)}
    assert sorted(got) == sorted(whole) == [0, 10, 11], (got, whole)
    for step in got:
        assert abs(got[step] - whole[step]) <= LOSS_ATOL, (step, got[step], whole[step])

    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.run([sys.executable, "-m", "repro.launch.train", *base, "--elastic",
                          "--ckpt-dir", str(tmp_path / "jax")],
                         env=env, capture_output=True, text=True, timeout=600)
    assert ref.returncode == 0, ref.stdout + ref.stderr
    assert "[train] mesh {'data': 2, 'model': 2}" in ref.stdout
    want = _losses(ref.stdout)
    for step in (0, 11):
        assert abs(got[step] - want[step]) <= LOSS_ATOL, (step, got[step], want[step])


def test_nccl_with_more_ranks_than_cards_names_gloo(tmp_path, monkeypatch):
    """On the card the ranks run over nccl, one card a rank: two ranks on a
    machine with one card are refused before any process starts, naming
    gloo (the CPU's backend, ``--device cpu``)."""
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(RuntimeError, match="nccl needs one CUDA device a rank") as err:
        train.main(["--arch", "internlm2-1.8b", "--reduced", "--nproc", "2",
                    "--ckpt-dir", str(tmp_path)])
    assert "backend='gloo'" in str(err.value)


_ONE_RANK = """
import sys
from repro_torch.launch import train
from repro_torch.runtime import workergroup

def no_rank_process(*args, **kwargs):
    raise AssertionError("a world of one started a rank process")

workergroup.spawn_group = no_rank_process
sys.exit(train.main(sys.argv[1:]))
"""


def test_elastic_on_one_device_trains_in_this_process(tmp_path):
    """``--elastic`` with one rank: the mesh {data 1, model 1} in the
    CLI's own process (no rank process), the same losses as a run
    without the mesh."""
    base = ["--arch", "internlm2-1.8b", "--reduced", "--steps", "3", "--batch", "2",
            "--seq", "32", "--ckpt-every", "0", "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=SRC)
    p = subprocess.run([sys.executable, "-c", _ONE_RANK, *base, "--elastic",
                        "--ckpt-dir", str(tmp_path / "mesh")],
                       env=env, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "[train] mesh {'data': 1, 'model': 1}" in p.stdout
    plain = _run(base[:-2] + ["--ckpt-dir", str(tmp_path / "plain")])
    assert plain.returncode == 0, plain.stdout + plain.stderr
    got, want = _losses(p.stdout), _losses(plain.stdout)
    assert sorted(got) == sorted(want) == [0, 2], (got, want)
    for step in got:
        assert abs(got[step] - want[step]) <= LOSS_ATOL, (step, got[step], want[step])
