"""Quickstart of the PyTorch/CUDA port: assess an RDF dataset on the card,
then re-assess it incrementally against a segment store.

  PYTHONPATH=src python examples/quickstart_torch.py               # card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # no card
"""
import argparse
import tempfile

from repro_torch import qa
from repro_torch.core import report
from repro_torch.rdf import bsbm_ntriples

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda",
                help="cuda (the hand-written kernels) or cpu (their plain "
                     "torch versions)")
device = ap.parse_args().device
BASE = ("http://bsbm.example.org/",)

# 1) get RDF data (here: synthetic BSBM e-commerce triples with known dirt)
nt_text = bsbm_ntriples(n_products=200, seed=42)

# 2+3) one call: parse + dictionary-encode + evaluate ALL metrics in ONE
#      pass of the fused_scan kernel (counters and HLL sketches together)
result = qa.assess(nt_text, metrics="all", base=BASE, device=device)

print(f"{len(result.values)} metrics from {result.passes} data pass "
      f"over {result.n_triples:,} triples on {device}:")
for name, value in sorted(result.values.items()):
    print(f"  {name:10s} {value:.4f}")

# the same assessment, spelled as a reusable fluent pipeline
pipe = qa.pipeline().metrics("paper").base(*BASE).device(device)
print(f"\n{pipe.describe()} -> L1={pipe.run(nt_text).values['L1']}")

# 4) machine-readable DQV report (paper §2.3)
print("\nDQV (first 300 chars):")
print(report.to_json(result)[:300], "…")

# 5) incremental re-assessment: the first run freezes each segment's
#    partial state in the store; after an append only the changed
#    segments are rescanned, and the result equals a cold assessment
with tempfile.TemporaryDirectory() as store:
    inc = qa.pipeline().metrics("all").base(*BASE).device(device) \
        .incremental(store, segment_bytes=16_384)
    inc.run(nt_text)
    edited = nt_text + bsbm_ntriples(n_products=3, seed=7)
    again = inc.run(edited)
    s = again.exec_stats
    print(f"\nafter an append: {s.segments_rescanned} of {s.chunks_total} "
          f"segments rescanned ({s.bytes_rescanned:,} of {s.bytes_total:,} "
          f"bytes), {s.segments_reused} reused")
    cold = qa.assess(edited, metrics="all", base=BASE, device=device)
    assert again.values == cold.values, "incremental differs from cold"
    print("incremental result identical to a cold assessment ✓")
