"""Report (``core/report.py``): the mean host milliseconds a request
spends in ``to_json``, from the span the benchmark puts around it: its
host clock in the traced window, where the profiler records the device's
side alone and no host operator."""


def read(run):
    if not run.requests:
        return None
    return sum(r.spans["report"][1] - r.spans["report"][0]
               for r in run.requests) / 1e6 / len(run.requests)
