"""Plain torch version of the fused_scan kernel — the same one-pass
contract (counts + every sketch register bank from one planes argument),
built from the independently tested reference pieces: the bytecode
interpreter (``core.expr.eval_program_torch``) and the scatter-max sketch
update (``core.sketches.hll_update``)."""
from __future__ import annotations

from ...core import sketches as hll
from ...core.expr import eval_program_torch
from ...rdf.triple_tensor import COL_S_FLAGS


def fused_scan_torch(planes, program, n_counters: int,
                     sketch_specs: tuple[tuple[str, tuple[int, ...]], ...],
                     p: int):
    """((n_counters,) int64 counts, {name: (2^p,) int32 registers})."""
    counts = eval_program_torch(planes, program, n_counters)
    valid = planes[:, COL_S_FLAGS] != 0   # any flag bit ⇒ real row
    regs = {name: hll.hll_update(hll.hll_init(p, planes.device), planes,
                                 cols, valid=valid)
            for name, cols in sketch_specs}
    return counts, regs
