"""Run one cell of the benchmark once and print its result line.

    python qabench/run.py --workload <config>.<mix> --seed <n> \
        --seconds <s> --trace <0|1>

Run from the root of a checkout, on a machine with the CUDA cards the cell
asks for. The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number that decides ``correct``
beside its limit, which also end standard error). See ``qabench/README.md``.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "qabench-cache"
# every cache of the program and of torch inside the checkout, at fixed
# paths, so that only a cell's first run there builds
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
# Python's bytecode too, whatever PYTHONDONTWRITEBYTECODE says: where the
# installed packages carry no __pycache__, every run would compile all of
# torch's sources again, seconds of set-up that swing from run to run.
sys.dont_write_bytecode = False
sys.pycache_prefix = str(CACHE / "pycache")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from qabench.harness.cell import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
