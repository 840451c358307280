"""The benchmark of the PyTorch and CUDA port ``hidenn_fem_tpu_torch``.

One run measures one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) on one card: ``python3 -m fembench.run --workload <name>
--seed <n> --seconds <s> --trace <0|1>``, from the repository root.  Every
part that belongs to one configuration, traffic mix, solver or per-layer
metric is a file of its own that the harness finds by the name in
``BENCHMARK.json`` (``fembench/harness.py`` says where).  Nothing here
imports JAX or the JAX package, and nothing under ``fembench/reference``
imports the port.
"""
