"""siddhi_tpu_torch — the PyTorch/CUDA port of siddhi_tpu.

A second package beside the JAX one, ported one slice at a time (see
ROADMAP.md).  It imports ``torch`` and ``numpy`` and nothing of JAX or of
the JAX package; the tests hold it bit for bit against that package.

Three slices so far:

- ``compile_pattern`` builds a ``DensePatternEngine`` for capture-free
  ``every`` chains, which steps a whole batch in one hand-written CUDA
  kernel on the card (``kernels/csrc/dense_batch.cu``: each partition's
  events in order, its state row in place) and in its plain torch
  version on the CPU;
- ``SiddhiManager`` runs partitioned pattern apps end to end through
  the dense runtime and, under ``@app:hotkeys``, the skew router, whose
  hot keys ride the fused scan kernel (``kernels/csrc/scan_chain.cu``);
- ``SiddhiManager`` runs ``define aggregation`` apps, whose device
  bucket bank adds each batch through the segmented-reduce kernel
  (``kernels/csrc/bank_scatter.cu``); ``rt.aggregations[...].find`` and
  ``rt.query`` pull from them.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from siddhi_tpu_torch.core.manager import SiddhiManager
from siddhi_tpu_torch.ops.dense_nfa import (
    compile_pattern,
    state_from_numpy,
    state_to_numpy,
)

__all__ = ["SiddhiManager", "compile_pattern", "state_from_numpy",
           "state_to_numpy"]
