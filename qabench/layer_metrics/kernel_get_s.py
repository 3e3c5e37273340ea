"""Kernel generator and build (``kernels/scan_codegen.py``,
``kernels/_build.py``): the wall seconds in which the program was getting
the cell's scan kernels, its counter ``kernel.build_ns``: the union over
every thread of printing a plan, reading a cubin from ``build/kernels/``
or compiling it with NVRTC, and loading it onto the card (with its
occupancy and attributes, at a plan's first launch). All of it falls in
set-up: the window finds every kernel in the process's cache. Unlike
``kernel_build_s``, which spans a dispatch of no rows, it holds the
module loads of the warm requests and nothing but the build. None where
nothing was built."""
from qabench.harness import program


def read(run):
    rec = program.record(run)
    if rec is None or not rec.counters.get(program.BUILD_BUSY):
        return None
    return rec.counters[program.BUILD_BUSY] / 1e9
