"""Scan kernels (``csrc/scan_spec.cuh`` through ``kernels/{fused_scan,
qap_count}/ops.py`` and ``kernels/_build.py::SpecKernel.launch``): the
bytes the kernels read as a share of the byte roofline, in %.

The bytes are what the program says a launch reads, the value of its
``kernel.launch`` span: the launch's rows × the bytes of a row the kernel
stages (``KernelSource.row_bytes``), not the bytes the request's metrics
need (``scan_bw_share``). Their sum over the traced window's requests,
over the card's HBM rate (``peaks.json``), divided by the device time of
those requests' scan kernels, each request paired with its scans as
``scan_bw_share`` pairs them: one whose scan or launch call the profiler
lost counts in neither sum.

The pairing puts the trace's launch calls and the program's spans on one
clock, so this reader also prints one line to standard error: the share
of the trace's scan kernels whose launch call falls inside a
``kernel.launch`` span (the two clocks agree where it is near 100%), and
the spans the recorder dropped at its cap."""
import sys

from qabench.harness import program


def read(run):
    t = run.trace
    rate = run.peak("hbm_bytes_per_s")
    spans = program.window_spans(run)
    if t is None or not t.scans or rate is None or spans is None:
        return None
    inside, total = program.launch_coverage(t.scans, spans)
    dropped = program.record(run).counters.get("spans.dropped", 0)
    print(f"program spans: {len(spans)} in the window, {dropped} dropped; "
          f"scan launch calls inside kernel.launch: {inside} of {total} "
          f"({100.0 * inside / max(1, total):.2f}%)", file=sys.stderr)
    reqs = run.requests
    seconds = t.scans_by_request([r.spans["dispatch"][0] for r in reqs],
                                 [r.spans["report"][1] for r in reqs])
    launches = program.by_request(
        run, [s for s in spans if s.name == "kernel.launch"])
    both = [i for i in seconds if i in launches]
    if not both:
        return None
    read_bytes = sum(s.value for i in both for s in launches[i])
    return 100.0 * read_bytes / rate / sum(seconds[i] for i in both)
