"""Sketches (``core/sketches.py``): the mean host milliseconds a request
of the traced window spends in the program's spans ``sketches.estimate``,
the HLL estimator run on the CPU over each sketch's merged registers in
``finalize_state``; a request whose plans have no sketch spends none."""
from qabench.harness import program


def read(run):
    return program.per_request_ms(run, "sketches.estimate")
