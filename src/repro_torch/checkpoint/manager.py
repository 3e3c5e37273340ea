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
* **sharded trees** — a tree of ``DTensor``s (weights placed on a mesh)
  is saved by every rank of the mesh together: each leaf is gathered
  whole (``dist.collectives.full_tensor``) and the mesh's first rank
  alone writes it, in the format above. ``restore(..., shardings=)``
  places each leaf onto a mesh (``distribute_tensor``): an elastic restart
  onto another mesh shape, or from a checkpoint of the JAX package.
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


def _host(v) -> np.ndarray:
    """A leaf as a host array: a ``DTensor`` gathered whole first."""
    if type(v).__name__ == "DTensor":
        from ..dist.collectives import full_tensor
        v = full_tensor(v)
    if hasattr(v, "detach"):
        v = v.detach().cpu()
    return np.asarray(v)


def _flatten(tree) -> dict[str, np.ndarray]:
    return {k: _host(v) for k, v in _leaves(tree)}


def _writer_rank(tree) -> bool:
    """Whether this process writes ``tree``: always, unless it holds
    ``DTensor``s and this is not the first rank of their mesh."""
    for _, v in _leaves(tree):
        if type(v).__name__ == "DTensor":
            import torch.distributed as dist
            return dist.get_rank() == int(v.device_mesh.mesh.flatten()[0])
    return True


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
        flat = _flatten(tree)    # every rank of a mesh gathers its leaves
        if _writer_rank(tree):
            self._write(step, flat, metadata or {})

    def save_async(self, step: int, tree,
                   metadata: dict[str, Any] | None = None):
        self.wait()  # one outstanding write at a time (raises if it failed)
        flat = _flatten(tree)  # host copy on the caller's thread
        if not _writer_rank(tree):
            return

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

    def restore(self, step: int, template, shardings=None):
        """Restore into the structure of ``template`` (host numpy leaves);
        optionally re-shard.

        ``shardings`` (a tree of ``template``'s structure whose leaves are
        ``dist.sharding.NamedSharding``s, as ``shardings_for_tree`` makes)
        places each leaf onto its mesh as a ``DTensor``: every rank of the
        mesh reads the file and keeps its own shard. This is how an elastic
        restart onto a different topology works.
        """
        self.wait()
        path = os.path.join(self.directory, f"step_{step:010d}", "arrays.npz")
        keys = [k for k, _ in _leaves(template)]
        with np.load(path) as data:
            missing = set(keys) - set(data.files)
            if missing:
                raise KeyError(
                    f"checkpoint missing keys: {sorted(missing)[:5]}")
            out = _rebuild(template, {k: data[k] for k in data.files})
        if shardings is None:
            return out
        import torch
        from torch.distributed.tensor import distribute_tensor
        places = dict(_leaves(shardings))
        return _rebuild(out, {
            k: distribute_tensor(torch.from_numpy(np.array(a)),
                                 places[k].mesh, places[k].placements,
                                 src_data_rank=None)
            for k, a in _leaves(out)})
