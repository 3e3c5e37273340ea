"""Print the readings the correctness limits are set from, one JSON line
a seed: the program's check numbers over a short window (``--seeds``) and
the control's (``--control-seeds``).

    python qabench/control.py --workload <cell> --seeds 1 2 3 \
        --control-seeds 4 5 6 --seconds 2

See ``harness/control.py``.
"""
import sys
import pathlib

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from qabench.harness.control import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
