"""Checkpointing: snapshots of nested dicts/lists of arrays + a manifest.

* **device-independent state** — arrays are gathered to host numpy before
  serialization, so a checkpoint restores on any device.
* **the JAX package's format** — a tree is flattened to the keys
  ``repro.checkpoint`` writes (its ``jax.tree_util.keystr`` paths: dict
  keys sorted, ``['counts'][0]``, ``['sketches']['spo']``) into the same
  ``step_<n>/{arrays.npz,manifest.json}`` layout, so a checkpoint written
  by either package restores in the other.
* **atomic** — writes go to ``<dir>/.tmp.<step>`` then ``os.replace`` into
  place; a crash mid-write never corrupts the latest checkpoint.
* **async** — ``save_async`` hands the host arrays to a writer thread so
  the assessment loop is not blocked on disk.
* **self-describing** — ``manifest.json`` records step, keys, shapes,
  dtypes and user metadata for compatibility checks on restore.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np


def _leaves(tree, prefix: str = ""):
    """(key, leaf) pairs in the order and with the key strings of
    ``jax.tree_util.tree_flatten_with_path`` + ``keystr``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _flatten(tree) -> dict[str, np.ndarray]:
    return {k: np.asarray(v) for k, v in _leaves(tree)}


def _rebuild(template, data, prefix: str = ""):
    """``template``'s structure with every leaf read from ``data``."""
    if isinstance(template, dict):
        return {k: _rebuild(v, data, f"{prefix}[{k!r}]")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, data, f"{prefix}[{i}]")
                              for i, v in enumerate(template))
    return data[prefix]


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._writer: threading.Thread | None = None
        self._writer_exc: BaseException | None = None

    # -- save ------------------------------------------------------------------
    def _write(self, step: int, flat: dict[str, np.ndarray],
               metadata: dict[str, Any]):
        tmp = os.path.join(self.directory, f".tmp.{step}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {
            "step": step,
            "keys": sorted(flat.keys()),
            "shapes": {k: list(v.shape) for k, v in flat.items()},
            "dtypes": {k: str(v.dtype) for k, v in flat.items()},
            "metadata": metadata,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)
        final = os.path.join(self.directory, f"step_{step:010d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def _gc(self):
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"),
                          ignore_errors=True)

    def save(self, step: int, tree, metadata: dict[str, Any] | None = None):
        # an async write of the same step would share its temp directory
        self.wait()
        self._write(step, _flatten(tree), metadata or {})

    def save_async(self, step: int, tree,
                   metadata: dict[str, Any] | None = None):
        self.wait()  # one outstanding write at a time (raises if it failed)
        flat = _flatten(tree)  # host copy on the caller's thread

        def _write_capturing():
            try:
                self._write(step, flat, metadata or {})
            except BaseException as e:  # re-raised on the caller's thread
                self._writer_exc = e

        self._writer = threading.Thread(target=_write_capturing, daemon=True)
        self._writer.start()

    def wait(self):
        """Join any in-flight async write; re-raises its exception (disk
        full, permissions, ...) on the caller's thread — a joined write
        either landed durably or this raises."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._writer_exc is not None:
            exc, self._writer_exc = self._writer_exc, None
            raise exc

    # -- restore ---------------------------------------------------------------
    def all_steps(self) -> list[int]:
        return sorted(int(name.split("_")[1])
                      for name in os.listdir(self.directory)
                      if name.startswith("step_"))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def manifest(self, step: int) -> dict:
        with open(os.path.join(self.directory, f"step_{step:010d}",
                               "manifest.json")) as f:
            return json.load(f)

    def restore(self, step: int, template):
        """Restore into the structure of ``template`` (host numpy leaves)."""
        self.wait()
        path = os.path.join(self.directory, f"step_{step:010d}", "arrays.npz")
        with np.load(path) as data:
            missing = set(_flatten(template)) - set(data.files)
            if missing:
                raise KeyError(
                    f"checkpoint missing keys: {sorted(missing)[:5]}")
            return _rebuild(template, {k: data[k] for k in data.files})
