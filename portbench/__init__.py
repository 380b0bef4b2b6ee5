"""The benchmark of the PyTorch and CUDA port (``open_gpu_kernel_modules_tpu_torch``).

One command runs one cell of ``BENCHMARK.json``::

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It serves a Mistral-family model through the port's continuous-batching
``Scheduler`` under a closed loop of clients, measures a window of
``--seconds``, checks the served tokens against the plain float32 reference in
``portbench/reference/`` and prints one JSON result as its last line.

Everything that belongs to one configuration, traffic mix or per-layer metric
is a file of its own, found by name: ``configs/<config>.json``,
``traffic/<traffic>.json`` and ``metrics/<metric>.py``.  Nothing here imports
JAX or the JAX package.
"""
