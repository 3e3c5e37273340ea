"""Evaluator (``core/evaluator.py``, ``qa/pipeline.py``): the mean host
milliseconds a request spends in ``dispatch_chunk``, ``merge_chunk`` and
``finalize_state``, from the spans the benchmark puts around its own
calls: its host clock in the traced window, where the profiler records
the device's side alone and no host operator. ``materialize_chunk``,
which waits for the scan, is left out."""

SPANS = ("dispatch", "merge", "finalize")


def read(run):
    if not run.requests:
        return None
    ns = sum(r.spans[s][1] - r.spans[s][0] for r in run.requests
             for s in SPANS)
    return ns / 1e6 / len(run.requests)
