"""Kernel generator and build (``kernels/scan_codegen.py``,
``kernels/_build.py``): the seconds of set-up spent getting the cell's
scan kernels. The benchmark spans each evaluator's ``dispatch_chunk`` on
no rows, which prints each plan's source and compiles it with NVRTC or
loads its cubin from ``build/kernels/`` (``SpecKernel.how``), and
launches nothing."""


def read(run):
    return run.setup.get("kernel_s")
