"""Serve a DIN recommender with the PyTorch port: online p99 scoring, bulk
retrieval, and LM decode on the smoke config — the counterpart of
``examples/serve_din.py``. On the card by default; ``--device cpu`` runs
it on the host.

  PYTHONPATH=src python examples/serve_din_torch.py
  PYTHONPATH=src python examples/serve_din_torch.py --device cpu
"""
import argparse
import os
import subprocess
import sys

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
ap.add_argument("--cands", type=int, default=100_000,
                help="candidates of the retrieval request")
ap.add_argument("--tokens", type=int, default=32)
args = ap.parse_args()

env = {**os.environ, "PYTHONPATH": "src"}
serve = [sys.executable, "-m", "repro_torch.launch.serve",
         "--device", args.device]
print("== online scoring (batch=64) ==", flush=True)
subprocess.run(serve + ["--model", "din", "--batch", "64", "--requests",
                        "20"], env=env, check=True)
print(f"== retrieval (1 user x {args.cands:,} candidates) ==", flush=True)
subprocess.run(serve + ["--model", "din", "--batch", "1", "--cands",
                        str(args.cands), "--requests", "5"], env=env,
               check=True)
print("== LM decode (smoke config) ==", flush=True)
subprocess.run(serve + ["--model", "lm", "--tokens", str(args.tokens)],
               env=env, check=True)
