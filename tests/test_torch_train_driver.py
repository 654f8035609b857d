"""The port's fault-tolerant driver (`repro_torch.launch.train`) on the CPU:
train → checkpoint → restart → resume, as the JAX package's driver test
runs it (``tests/test_train_driver.py``), with ``--device cpu``; the
driver's checkpoints resume in JAX's driver; what is not ported raises
naming its ROADMAP item; whisper-tiny and llava-next-34b fail as JAX's
driver fails on them, its token pipeline giving no frames or patches.
"""

import os

import numpy as np
import pytest
import torch

from repro.launch.train import main as jtrain_main
from repro_torch.launch.train import build_argparser, main as train_main


def _steps(ckpt):
    return sorted(int(f.split("_")[1].split(".")[0])
                  for f in os.listdir(ckpt) if f.endswith(".npz"))


def test_driver_trains_and_auto_resumes(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    rc = train_main([
        "--arch", "granite-3-8b", "--smoke", "--steps", "6", "--batch", "4",
        "--seq", "32", "--ckpt-dir", ckpt, "--ckpt-every", "3",
        "--log-every", "2", "--warmup", "2", "--device", "cpu",
    ])
    assert rc == 0
    out1 = capsys.readouterr().out
    assert "step     6" in out1
    assert 6 in _steps(ckpt)
    # Restart: must auto-resume from step 6 and run only steps 7..10.
    rc = train_main([
        "--arch", "granite-3-8b", "--smoke", "--steps", "10", "--batch", "4",
        "--seq", "32", "--ckpt-dir", ckpt, "--ckpt-every", "100",
        "--log-every", "2", "--warmup", "2", "--device", "cpu",
    ])
    assert rc == 0
    out2 = capsys.readouterr().out
    assert "resumed from step 6" in out2
    assert "steps 6->10" in out2
    assert "step     8" in out2 and "step     2" not in out2
    assert _steps(ckpt)[-1] == 10


def test_port_checkpoint_resumes_in_the_jax_driver(tmp_path, capsys):
    """The port's driver writes JAX's layout: JAX's driver picks its
    checkpoint up and trains on from it."""
    ckpt = str(tmp_path / "ckpt")
    args = ["--arch", "qwen3-8b", "--smoke", "--batch", "2", "--seq", "16",
            "--ckpt-dir", ckpt, "--log-every", "1", "--warmup", "1"]
    assert train_main(args + ["--steps", "2", "--device", "cpu"]) == 0
    capsys.readouterr()
    assert jtrain_main(args + ["--steps", "3"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "steps 2->3" in out
    assert _steps(ckpt)[-1] == 3
    assert train_main(args + ["--steps", "4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and "steps 3->4" in out


@pytest.mark.parametrize("extra", [
    ["--schedule", "wsd", "--microbatch", "2"],
    ["--orthogonal-update", "--grad-compression"],
])
def test_driver_options(extra, capsys):
    rc = train_main(["--arch", "qwen3-8b", "--smoke", "--steps", "3",
                     "--batch", "4", "--seq", "32", "--log-every", "1",
                     "--warmup", "1", "--device", "cpu"] + extra)
    assert rc == 0
    out = capsys.readouterr().out
    assert "step     3" in out and "loss" in out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 3 and np.all(np.isfinite(losses))
    if "--grad-compression" in extra:
        assert "--grad-compression requested but mesh has no `pod`" in out


def test_driver_halts_on_a_non_finite_loss(tmp_path, capsys):
    """A learning rate of 1e30 sends the weights to inf within a step or
    two: the driver stops with rc 2 before it writes a checkpoint."""
    ckpt = str(tmp_path / "ckpt")
    rc = train_main(["--arch", "qwen3-8b", "--smoke", "--steps", "5",
                     "--batch", "2", "--seq", "16", "--lr", "1e30",
                     "--warmup", "0", "--log-every", "1", "--ckpt-dir", ckpt,
                     "--device", "cpu"])
    assert rc == 2
    assert "non-finite loss" in capsys.readouterr().out
    assert _steps(ckpt) == []


@pytest.mark.parametrize("argv,item", [
    (["--arch", "jamba-v0.1-52b", "--model-parallel", "2"], "A14.6"),
    (["--mesh", "single"], "A14.6"),
    (["--mesh", "multi"], "A14.6"),
    (["--model-parallel", "2"], "A14.6"),
])
def test_driver_refuses_what_is_not_ported(argv, item):
    with pytest.raises(NotImplementedError, match=item):
        train_main(["--smoke", "--steps", "1", "--batch", "2", "--seq", "16",
                    "--device", "cpu"] + argv)


@pytest.mark.parametrize("arch,key", [("llava-next-34b", "patches"),
                                      ("whisper-tiny", "frames")])
def test_driver_fails_as_jax_without_frames_or_patches(arch, key):
    """The token pipeline gives tokens only, in both packages: the first
    step of either driver fails with a `KeyError` naming the input its
    batch lacks."""
    argv = ["--arch", arch, "--smoke", "--steps", "1", "--batch", "2",
            "--seq", "16"]
    for driver, extra in ((jtrain_main, []), (train_main, ["--device",
                                                           "cpu"])):
        with pytest.raises(KeyError) as err:
            driver(argv + extra)
        assert err.value.args == (key,)


def test_driver_defaults_to_the_card():
    assert build_argparser().parse_args([]).device is None
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the default is exercised there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_main(["--smoke", "--steps", "1"])
