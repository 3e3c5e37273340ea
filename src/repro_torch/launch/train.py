"""LM training launcher of the port: the loop of ``repro.launch.train``
with checkpointing and restart, the same flags and printed lines, plus
each step's milliseconds and, at the end, a summary line. It runs on the
card (``--device cuda``, the default) and fails where there is none;
``--device cpu`` runs it on the host:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-14b \\
      --scale smoke --steps 100 --ckpt-dir ckpt/lm --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch granite-moe-1b-a400m --scale full --batch 8 --seq 4096 --steps 8

``--scale smoke`` uses the arch's reduced config, ``small`` a ~100M-class
config of the same family, ``full`` the assigned config. Data: the JAX
launcher's synthetic zipf(1.3) token stream from seed 1234, drawn anew
from its start by a resumed run, as the JAX launcher does. Checkpoints
have the JAX launcher's keys and layout (``models/convert.py``): a run
of either package resumes from the other's.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..configs import lm_config
from ..models import transformer as tf
from ..models.common import require_device
from ..models.convert import train_state_from_numpy, train_state_to_numpy
from ..optim import AdamW, cosine_schedule

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak at 700 W
H100_BF16_FLOPS_PER_S = 989e12


def token_batches(cfg, batch: int, seq: int):
    """The JAX launcher's synthetic corpus: zipf-distributed token batches
    from ``np.random.default_rng(1234)``, (batch, seq) int32."""
    rng = np.random.default_rng(1234)
    while True:
        yield rng.zipf(1.3, size=(batch, seq)).clip(
            max=cfg.vocab_size - 1).astype(np.int32)


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(torch.cuda.current_device())],
        capture_output=True, text=True, check=True).stdout.strip()


def restore(cfg, mgr: CheckpointManager, step: int, state: dict,
            device) -> dict:
    """The train state of checkpoint ``step`` (written by either package),
    on ``device``; ``state`` gives the keys to read."""
    tree = mgr.restore(step, train_state_to_numpy(cfg, state))
    return train_state_from_numpy(cfg, tree, device)


def train(cfg, *, steps: int, batch: int = 8, seq: int = 128,
          lr: float = 3e-4, ckpt_dir=None, ckpt_every: int = 20,
          resume: bool = False, device="cuda", label=None) -> dict:
    """The training loop of ``main``: AdamW with a cosine schedule (warmup
    ``max(steps // 20, 1)``), weights from seed 0, checkpoints every
    ``ckpt_every`` steps (async) and at the end. Returns the final state
    and, for each step run, its loss, aux loss and milliseconds (host
    clock, ending in a synchronize), with the peak bytes on a card."""
    device = require_device(device)
    label = label or cfg.name
    model, _ = tf.init_transformer(
        cfg, torch.Generator(device).manual_seed(0), trainable=True)
    print(f"{label}: {sum(p.numel() for p in model.parameters()):,} params")
    opt = AdamW(lr=cosine_schedule(lr, warmup=max(steps // 20, 1),
                                   total=steps))
    state = {"params": model, "opt": opt.init(model.tree()),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start = 0
    if mgr and resume and mgr.latest_step() is not None:
        state = restore(cfg, mgr, mgr.latest_step(), state, device)
        start = int(state["step"])
        print(f"resumed from step {start}")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    step_fn = tf.make_train_step(cfg, opt)
    batches = token_batches(cfg, batch, seq)
    losses, auxes, step_ms = [], [], []
    t0 = time.perf_counter()
    for step in range(start, steps):
        toks = torch.from_numpy(next(batches)).to(device)
        t = time.perf_counter()
        state, metrics = step_fn(state, {"tokens": toks})
        losses.append(float(metrics["loss"]))      # waits for the step
        auxes.append(float(metrics["aux_loss"]))
        step_ms.append((time.perf_counter() - t) * 1e3)
        if step % 10 == 0 or step == steps - 1:
            dt = time.perf_counter() - t0
            tok_s = batch * seq * (step - start + 1) / max(dt, 1e-9)
            print(f"step {step:5d}  loss {losses[-1]:.4f}  "
                  f"aux {auxes[-1]:.4f}  {tok_s:,.0f} tok/s  "
                  f"{step_ms[-1]:.1f} ms", flush=True)
        if mgr and (step + 1) % ckpt_every == 0:
            mgr.save_async(step + 1, train_state_to_numpy(cfg, state))
    if mgr:
        mgr.save(steps, train_state_to_numpy(cfg, state))
        mgr.wait()
    out = {"state": state, "losses": losses, "aux": auxes,
           "step_ms": step_ms, "tokens_per_step": batch * seq,
           "peak_bytes": (torch.cuda.max_memory_allocated(device)
                          if device.type == "cuda" else None)}
    if step_ms:
        print(summary(cfg, out, device))
    print("done.")
    return out


def summary(cfg, out: dict, device) -> str:
    """The run's step time (p50 over the steps after the first, or the one
    step), tokens/s and, on a card, model TFLOP/s (6 · active params ·
    tokens a step) with its share of the bf16 peak and the peak bytes,
    beside the card's name and power limit."""
    ms = out["step_ms"][1:] or out["step_ms"]
    p50 = float(np.median(ms))
    line = (f"device {device}: step p50 {p50:.1f} ms over {len(ms)} steps, "
            f"{out['tokens_per_step'] / p50 * 1e3:,.0f} tok/s")
    if device.type != "cuda":
        return line
    flops = 6 * cfg.num_active_params() * out["tokens_per_step"]
    rate = flops / (p50 / 1e3)
    return (f"{line}, model {rate / 1e12:.1f} TFLOP/s "
            f"({rate / H100_BF16_FLOPS_PER_S:.1%} of 989 TFLOP/s bf16), "
            f"peak {out['peak_bytes']:,} bytes  [{card_line()}]")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-14b")
    ap.add_argument("--scale", choices=["smoke", "small", "full"],
                    default="smoke")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    args = ap.parse_args()
    train(lm_config(args.arch, args.scale), steps=args.steps,
          batch=args.batch, seq=args.seq, lr=args.lr,
          ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
          resume=args.resume, device=args.device,
          label=f"{args.arch} [{args.scale}]")


if __name__ == "__main__":
    main()
