"""Train checkpoints crossing the packages through their launchers:
``repro.launch.train`` (JAX) and ``repro_torch.launch.train --device
cpu``, each in a process of its own, at ``--scale smoke`` (granite's SMOKE:
MoE, the chunked loss padded from 32 positions to 512).

JAX writes steps 2 and 4 (two runs, the second resuming the first); the
port and JAX each resume from step 4 and print step 5 (index 4); the
port writes steps 1 and 2 (``save_async``, then the final ``save``) and
JAX and the port each resume from step 2. The resumed runs' losses agree
to ``rtol=1e-4`` (printed with 4 decimals). A resumed run draws its
tokens from the stream's start, in both launchers.

The JAX runs write no step twice: with ``--steps`` a multiple of
``--ckpt-every`` its final ``save`` and the last ``save_async`` of the
same step race for one temporary directory (the port's ``save`` waits).
"""
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ARGS = ["--arch", "granite-moe-1b-a400m", "--scale", "smoke", "--batch",
        "4", "--seq", "32"]
LINE = re.compile(r"step\s+(\d+)\s+loss\s+([\d.]+)\s+aux\s+([\d.]+)")


def launch(package, *args):
    """Run a launcher; (its stdout, {step: (loss, aux)} of the lines it
    printed)."""
    cmd = [sys.executable, "-m", f"{package}.launch.train", *ARGS, *args]
    if package == "repro_torch":
        cmd += ["--device", "cpu"]
    env = {**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    steps = {int(m[1]): (float(m[2]), float(m[3]))
             for m in LINE.finditer(proc.stdout)}
    return proc.stdout, steps


def steps_on_disk(d):
    return sorted(int(n.split("_")[1]) for n in os.listdir(d)
                  if n.startswith("step_"))


def test_train_checkpoints_cross_the_launchers(tmp_path):
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "from_jax"
    launch("repro", "--steps", "2", "--ckpt-every", "100",
           "--ckpt-dir", str(jax_dir))
    out, _ = launch("repro", "--steps", "4", "--ckpt-every", "100",
                    "--ckpt-dir", str(jax_dir), "--resume")
    assert "resumed from step 2" in out
    assert steps_on_disk(jax_dir) == [2, 4]
    shutil.copytree(jax_dir, port_dir)

    # JAX → port: both continue from step 4
    out, port = launch("repro_torch", "--steps", "5", "--ckpt-dir",
                       str(port_dir), "--resume")
    assert "resumed from step 4" in out and set(port) == {4}
    out, jax_ = launch("repro", "--steps", "5", "--ckpt-dir", str(jax_dir),
                       "--resume")
    assert "resumed from step 4" in out and set(jax_) == {4}
    np.testing.assert_allclose(port[4], jax_[4], rtol=1e-4)
    assert steps_on_disk(port_dir) == [2, 4, 5]

    # port → JAX: a port checkpoint restores under JAX's launcher (a
    # missing key raises there) and both continue from step 2
    written, jax_dir2 = tmp_path / "port", tmp_path / "from_port"
    launch("repro_torch", "--steps", "2", "--ckpt-every", "1",
           "--ckpt-dir", str(written))
    assert steps_on_disk(written) == [1, 2]
    shutil.copytree(written, jax_dir2)
    out, jax_ = launch("repro", "--steps", "3", "--ckpt-dir",
                       str(jax_dir2), "--resume")
    assert "resumed from step 2" in out and set(jax_) == {2}
    out, port = launch("repro_torch", "--steps", "3", "--ckpt-dir",
                       str(written), "--resume")
    assert "resumed from step 2" in out
    np.testing.assert_allclose(port[2], jax_[2], rtol=1e-4)


def test_launcher_without_a_card_names_the_device():
    """The default ``--device cuda`` fails where there is no card, with an
    error that names the device; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    env = {**os.environ, "PYTHONPATH": "src"}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *ARGS,
         "--steps", "1"], env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert "device cuda" in proc.stderr and "no CUDA card" in proc.stderr
    assert "params" not in proc.stdout
