"""Host copy (``core/evaluator.py``'s ``materialize_chunk``): the mean
host milliseconds a request of the traced window spends in the program's
span ``evaluator.materialize`` after its scan kernel has ended, that is
in the ``.cpu().numpy()`` copies of its counters and registers and not
in the wait for the scan, which the first copy holds. The scan's end is
put on the host's clock from the trace (``program.scans_end``: it starts
at its launch call on the idle card), so a few microseconds of launch
latency count as copy. Requests whose scan or launch call the profiler
lost are left out."""
from qabench.harness import program


def read(run):
    spans = program.window_spans(run)
    if spans is None or run.trace is None:
        return None
    ends = program.scans_end(run)
    mats = program.by_request(
        run, [s for s in spans if s.name == "evaluator.materialize"])
    both = [i for i in ends if i in mats]
    if not both:
        return None
    return sum(s.end - max(s.start, ends[i]) for i in both
               for s in mats[i]) / 1e6 / len(both)
