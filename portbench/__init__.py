"""The benchmark of the PyTorch and CUDA port (``modular_rag_system_tpu_torch``).

``run.py`` runs one cell once; ``BENCHMARK.json`` at the root of the
repository names the cells and metrics, and each piece lives in a file
of its own (see ``common.py``).  Nothing here imports JAX or the JAX
package, and the plain reference (``reference/``) imports nothing of the
port.
"""
