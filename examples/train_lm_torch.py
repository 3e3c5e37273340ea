"""Train a small LM end to end with checkpoint/restart through the PyTorch
port — the counterpart of ``examples/train_lm.py``. On the card by
default; ``--device cpu`` runs it on the host. Any flag of
``python -m repro_torch.launch.train`` overrides the defaults below (the
smoke config, 60 steps, checkpoints under the checkout's ``build/``; run
it again with ``--resume --steps 120`` to continue from the last one).

  PYTHONPATH=src python examples/train_lm_torch.py
  PYTHONPATH=src python examples/train_lm_torch.py --device cpu   # ~10 s
  PYTHONPATH=src python examples/train_lm_torch.py --scale small --steps 300
"""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
defaults = ["--scale", "smoke", "--steps", "60", "--ckpt-dir",
            os.path.join(ROOT, "build", "train_lm_ckpt")]
subprocess.run([sys.executable, "-m", "repro_torch.launch.train"]
               + defaults + sys.argv[1:],
               env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")},
               check=True)
