"""Kernel launch path (``kernels/{fused_scan,qap_count}/ops.py``,
``kernels/_build.py``'s ``launch_scan`` and ``SpecKernel.launch``): the
mean host milliseconds a scan launch of the traced window spends in the
program's spans ``kernel.check`` (the arguments), ``kernel.outputs`` (the
zeroed outputs), ``kernel.source`` (the printed plan, cached),
``kernel.get`` (the compiled kernel, cached) and ``kernel.launch`` (up to
the return of ``cuLaunchKernel``), over the ``kernel.launch`` spans."""
from qabench.harness import program


def read(run):
    spans = program.window_spans(run)
    if spans is None:
        return None
    launches = sum(1 for s in spans if s.name == "kernel.launch")
    if not launches:
        return None
    return program.total_ns(spans, program.LAUNCH_PATH) / 1e6 / launches
