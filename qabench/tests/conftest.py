"""Fixtures of the benchmark's tests: the checkout's ``src`` and root on
the path, cells cut to a CPU-sized dataset, and the card (tests marked
``gpu`` skip where there is none)."""
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def small_cell():
    """``small_cell(name, triples)``: the cell of BENCHMARK.json with its
    dataset cut to ``triples`` rows."""
    from qabench.harness import spec

    def make(name, triples=20_000):
        cell = spec.load_cell(name)
        cell.config["triples"] = triples
        return cell
    return make


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
