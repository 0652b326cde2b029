"""The benchmark of ``avjepa_tpu_torch`` on NVIDIA GPUs, driven by
``BENCHMARK.json`` at the repository's root; see ``README.md``."""
