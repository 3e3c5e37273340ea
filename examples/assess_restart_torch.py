"""Fault-tolerant assessment with the PyTorch/CUDA port: chunked scan,
injected failures + a straggler, a coordinator crash, and an exact resume
from the checkpoint.

  PYTHONPATH=src python examples/assess_restart_torch.py               # card
  PYTHONPATH=src python examples/assess_restart_torch.py --device cpu  # no card
"""
import argparse
import tempfile

from repro_torch.core import ALL_METRICS, QualityEvaluator
from repro_torch.dist import ChunkScheduler, FaultInjector, WorkerFailure
from repro_torch.rdf import synth_encoded

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda",
                help="cuda (the hand-written kernels) or cpu (their plain "
                     "torch versions)")
device = ap.parse_args().device

dataset = synth_encoded(200_000, seed=7)
evaluator = QualityEvaluator(ALL_METRICS, fused=True, backend="fused_scan",
                             device=device)
reference = evaluator.assess(dataset)

with tempfile.TemporaryDirectory() as ckpt_dir:
    sched = ChunkScheduler(evaluator, n_chunks=24, checkpoint_dir=ckpt_dir,
                           checkpoint_every=6)
    # two flaky workers, one straggler, and a coordinator crash at merge 12
    faults = FaultInjector(fail_chunks={3: 2, 11: 1},
                           slow_chunks={5: 0.5},
                           crash_after_merges=12)
    try:
        sched.run(dataset, faults=faults)
    except WorkerFailure as e:
        print(f"crashed as injected: {e}")
    else:
        raise SystemExit("the coordinator did not crash as injected")

    print("restarting from checkpoint …")
    sched2 = ChunkScheduler(evaluator, n_chunks=24, checkpoint_dir=ckpt_dir,
                            checkpoint_every=6)
    result, stats = sched2.run(dataset)
    print(f"resumed from merge {stats.resumed_from}; "
          f"attempts after restart: {stats.attempts}/24")

assert stats.resumed_from is not None, "the second run did not resume"
assert result.values == reference.values, "resumed result differs"
assert result.registers.keys() == reference.registers.keys()
for k in reference.registers:
    assert (result.registers[k] == reference.registers[k]).all(), k
print(f"fault-tolerant result identical to the single-pass reference on "
      f"{device} ✓")
