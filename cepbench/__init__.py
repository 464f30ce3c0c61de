"""cepbench: the benchmark of ``siddhi_tpu_torch`` on an NVIDIA GPU.

``python cepbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` through
``SiddhiManager`` on the card and prints one JSON result line.  Every
configuration, traffic mix, reference, readout and per-layer reader
is a file of its own here, found by the name ``BENCHMARK.json`` gives it
(``harness.py``).
"""
