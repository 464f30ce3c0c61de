"""Hand-written CUDA kernels of the port and their plain torch versions.

- ``dense_batch``: the batch dense-NFA step (``csrc/dense_batch.cu``),
  replacing the JAX package's Pallas ``build_packed_nfa`` and the
  collision rounds around it: one launch a batch, each partition's
  events in order, state rows in place.  The engine's main path.
- ``dense_step``: the packed dense-NFA step (``csrc/dense_step.cu``),
  the Pallas kernel's interface-level twin, off the main path;
  ``plane_pack`` holds the bit layout.
- ``probe``: the build-and-launch check (``csrc/probe.cu``).
- ``scan_chain``: the fused hot-key scan (``csrc/scan_chain.cu``).
- ``bank_scatter``: the aggregation bank's segmented reduce
  (``csrc/bank_scatter.cu``): the delta (``segmented_reduce``) or folded
  into the bank's lane in place (``accumulate_``).

``build`` compiles ``csrc/*.cu`` with ``nvcc`` at first use and sets
every C entry's ctypes prototype once, when it loads the library.  A wrapper
launches its kernel for a CUDA tensor and uses the plain version only
for a CPU tensor; each counts its launches (``<wrapper>.launches``).
"""
