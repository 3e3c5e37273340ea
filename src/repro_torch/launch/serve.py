"""Serving launcher of the port: batched DIN scoring / LM decode, the
counterpart of ``repro.launch.serve`` with the same flags and lines. It
runs on the card (``--device cuda``, the default) and fails where there is
none; ``--device cpu`` runs it on the host:

  PYTHONPATH=src python -m repro_torch.launch.serve --model din --batch 64
  PYTHONPATH=src python -m repro_torch.launch.serve --model lm --tokens 32
  PYTHONPATH=src python -m repro_torch.launch.serve --model lm --device cpu

``serve_din`` and ``serve_lm`` also take a config, weights and a device as
keywords, and return what they served with its latencies (host clock,
each request ending in a synchronize).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import qwen2_5_14b
from ..models import din as M
from ..models import transformer as tf


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def p50_p99(lat: list) -> tuple[float, float]:
    """The JAX launcher's p50 and p99 of a list of latencies."""
    lat = sorted(lat)
    return lat[len(lat) // 2], lat[min(int(len(lat) * .99), len(lat) - 1)]


def serve_din(batch: int, n_cands: int, requests: int, *, cfg=None,
              params=None, device="cuda") -> dict:
    """Scores ``requests`` synthetic batches (after one warm-up batch).

    Defaults: DIN with 100,000 items and 1,000 categories, weights from
    seed 0. Returns the per-request latencies (seconds), the last
    request's scores (B, C) and its numpy batch."""
    cfg = cfg or dataclasses.replace(M.DINConfig(), n_items=100_000,
                                     n_cats=1000)
    if params is None:
        params, _ = M.init_din(cfg, torch.Generator(device).manual_seed(0))
    rng = np.random.default_rng(0)
    reduced = {"n_items": cfg.n_items, "n_cats": cfg.n_cats}
    b = M.synth_batch(cfg, batch, n_cands, rng, reduced=reduced)
    M.forward(cfg, params, M.to_device(b, device))  # warm-up
    _sync(device)
    lat = []
    for _ in range(requests):
        b = M.synth_batch(cfg, batch, n_cands, rng, reduced=reduced)
        t0 = time.perf_counter()
        out = M.forward(cfg, params, M.to_device(b, device))
        _sync(device)
        lat.append(time.perf_counter() - t0)
    p50, p99 = p50_p99(lat)
    print(f"din: batch={batch} cands={n_cands} reqs={requests}  "
          f"p50={p50 * 1e3:.2f}ms p99={p99 * 1e3:.2f}ms  "
          f"{batch * n_cands / p50:,.0f} scores/s")
    return {"latencies_s": lat, "scores": out, "batch": b}


def serve_lm(n_tokens: int, *, cfg=None, params=None,
             device="cuda") -> dict:
    """Greedy decode of ``n_tokens`` after a 16-token prompt drawn from
    ``np.random.default_rng(0)``.

    Defaults: ``qwen2_5_14b.SMOKE``, weights from seed 0. Returns the
    prompt, the generated ids, the prefill's seconds (to the first id),
    each decode step's seconds, and the logits each id was taken from
    ``(1, n_tokens, V)``."""
    label = "smoke config" if cfg is None else cfg.name
    cfg = cfg or qwen2_5_14b.SMOKE
    if params is None:
        params, _ = tf.init_transformer(
            cfg, torch.Generator(device).manual_seed(0))
    prompt = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 16)),
        dtype=torch.int32).to(device)
    s_max = 16 + n_tokens
    t0 = time.perf_counter()
    logits, cache = tf.prefill(cfg, params, prompt, s_max=s_max)
    tok = torch.argmax(logits[:, -1:], -1)
    out = [int(tok[0, 0])]
    prefill_s = time.perf_counter() - t0
    steps = [logits[:, -1:]]
    dec = []
    t0 = time.perf_counter()
    for i in range(n_tokens - 1):
        t = time.perf_counter()
        logits, cache = tf.decode_step(cfg, params, cache, tok, 16 + i)
        tok = torch.argmax(logits, -1)
        out.append(int(tok[0, 0]))
        dec.append(time.perf_counter() - t)
        steps.append(logits)
    dt = time.perf_counter() - t0
    print(f"lm decode: {n_tokens} tokens in {dt:.2f}s "
          f"({n_tokens / dt:.1f} tok/s, {label})  ids={out[:10]}…")
    return {"prompt": prompt, "ids": out, "prefill_s": prefill_s,
            "decode_s": dec, "logits": torch.cat(steps, dim=1)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=["din", "lm"], default="din")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--cands", type=int, default=1)
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    args = ap.parse_args()
    if args.model == "din":
        serve_din(args.batch, args.cands, args.requests, device=args.device)
    else:
        serve_lm(args.tokens, device=args.device)


if __name__ == "__main__":
    main()
