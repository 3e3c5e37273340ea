"""Scan kernels (``csrc/scan_spec.cuh`` through ``kernels/{fused_scan,
qap_count}/ops.py`` and ``kernels/_build.py::SpecKernel.launch``): their
share of the byte roofline, in %.

The bytes are what each request's metrics need, not what the kernel
reads: rows × 4 B for each plane in the union of the planes its metrics
test or hash, with the VALID plane (``plane_table.json``, frozen). Their
sum over the traced window's requests, over the card's HBM rate
(``peaks.json``), divided by the device time of those requests' scan
kernels in the trace. A scan kernel's request is the one whose span holds
the kernel's launch call; where the profiler lost a scan's record, or its
launch call's, its request counts in neither sum. The kernel reads all 13
planes of a row, so on this layout the share cannot pass needed / 52 B of
a row.
"""


def read(run):
    t = run.trace
    if t is None or not t.scans:
        return None
    rate = run.peak("hbm_bytes_per_s")
    if rate is None:
        return None
    reqs = run.requests
    seconds = t.scans_by_request([r.spans["dispatch"][0] for r in reqs],
                                 [r.spans["report"][1] for r in reqs])
    if not seconds:
        return None
    need = sum(reqs[i].rows * run.bytes_needed(reqs[i].k) for i in seconds)
    return 100.0 * need / rate / sum(seconds.values())
