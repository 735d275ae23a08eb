"""The benchmark of the PyTorch and CUDA port, ``repas_tpu_torch``.

Driven by ``BENCHMARK.json`` at the root of the repository; run a cell
with ``python3 -m benchmark.run`` (see ``benchmark/README.md``). Nothing
here imports JAX or the JAX package, and the plain references under
``benchmark/reference/`` import nothing of the program.
"""
