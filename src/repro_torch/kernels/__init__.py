"""Hand-written CUDA kernels for the assessment scan (Hopper, ``sm_90a``).

* ``qap_count`` — fused multi-metric predicate+count scan (the paper's
  metric evaluation loop, one pass over the planes for all metrics).
* ``fused_scan`` — the one-true-pass scan: the counters AND every HLL
  sketch's register bank in the same pass over the planes.
* ``hll`` (``hll_fold``) — one HLL sketch's register bank alone, one pass
  per sketch: the sketch half of the two-pass backend.

``qap_count`` and ``fused_scan`` are one kernel, specialized per plan:
``scan_codegen`` prints the plan as straight-line CUDA around the
hand-written block structure ``csrc/scan_spec.cuh``. ``hll_fold`` is a
fixed source, ``csrc/hll_fold.cu``. ``_build`` compiles both with NVRTC
on first use and launches them through the CUDA driver API. Each wrapper
in ``*/ops.py`` launches its kernel for a CUDA tensor and runs the plain
torch version in ``*/ref.py`` only for a CPU tensor.

Pass accounting
---------------
Every op wrapper that streams the full planes tensor once calls
``record_scan()`` before it dispatches on the device, so running one pass
function under ``count_scans()`` counts its data passes per execution on
any device — the hook behind ``QualityEvaluator.passes_per_chunk``.

Launch accounting
-----------------
A fake or meta tensor on the card (``shape_only``: a traced step's) takes
a third route: the arguments are checked, the outputs made empty of the
right shape, dtype and device, and nothing is launched or counted in
``LAUNCHES``. Either way the call is told to ``KERNEL_OBSERVERS`` as one
op reading the planes and writing the outputs.

``LAUNCHES`` holds one count per kernel. A wrapper adds one, through
``record_launch``, where it launches its kernel on the card, and nowhere
else, so a run can show that it went through the kernels:
``reset_launches()`` before, read after. The count is taken under a lock:
the scheduler launches kernels from worker threads too.

Spans
-----
With recording on (``repro_torch.tracing``) a wrapper's launch path is
timed in steps: ``kernel.check`` (the arguments), ``kernel.outputs`` (the
zeroed outputs), for the scan kernel ``kernel.source`` (the printed
plan, cached), and for both kernels ``kernel.get`` (the compiled kernel:
the process's cache, else the cubin on disk, else NVRTC),
``kernel.module`` (its first load on a card) and ``kernel.launch`` (up to
the return of ``cuLaunchKernel``, carrying the bytes of the rows the
launch reads).
"""
from __future__ import annotations

import contextlib
import sys
import threading

LAUNCHES: dict[str, int] = {"qap_count": 0, "fused_scan": 0, "hll_fold": 0}
_launch_lock = threading.Lock()


def reset_launches() -> None:
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def record_launch(name: str) -> None:
    """Count one launch of kernel ``name`` (safe from any thread)."""
    with _launch_lock:
        LAUNCHES[name] += 1


def shape_only(t) -> bool:
    """Whether ``t`` holds no data: a meta tensor, or a fake one (under
    ``FakeTensorMode``, a traced step's). A wrapper given one on the card
    checks its arguments and returns outputs of the right shape, dtype and
    device, launching nothing; a real tensor never takes that route."""
    if t.device.type == "meta":
        return True
    # a fake tensor exists only once its module is loaded: nothing imported
    fake = sys.modules.get("torch._subclasses.fake_tensor")
    return fake is not None and isinstance(t, fake.FakeTensor)


# told of every kernel call, launched or shape-only, as
# ``f(bytes read, tensors written)``: a traced step's meter counts the
# kernel as one op (``launch/trace.py``)
KERNEL_OBSERVERS: list = []


def note_kernel(read_bytes: int, written) -> None:
    for f in KERNEL_OBSERVERS:
        f(read_bytes, written)


class _ScanCounter(threading.local):
    active = False
    count = 0


_scans = _ScanCounter()


def record_scan(n: int = 1) -> None:
    """Declare ``n`` full passes over the planes tensor (a no-op unless
    inside ``count_scans()``)."""
    if _scans.active:
        _scans.count += n


@contextlib.contextmanager
def count_scans():
    """Count ``record_scan`` calls in this thread; yields a 1-element list
    whose slot holds the running (and, on exit, final) count."""
    prev_active, prev_count = _scans.active, _scans.count
    _scans.active, _scans.count = True, 0
    box = [0]
    try:
        yield box
        box[0] = _scans.count
    finally:
        _scans.active, _scans.count = prev_active, prev_count
