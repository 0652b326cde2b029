"""AV-JEPA on PyTorch and CUDA: the port of ``avjepa_tpu`` to one NVIDIA H100.

The JAX package ``avjepa_tpu`` stays the reference. This package mirrors its
module paths, reads the same YAML configs, and imports neither JAX nor the
JAX package (it keeps its own copies of the host modules it needs). Its
attention kernels are written by hand for Hopper (``csrc/``) and built with
``nvcc`` at first use (``ops/_build.py``); every other operation is stock
PyTorch. It runs the ``avjepa`` / ``vjepa`` pretrain apps, the ``extract``
serving app, the ``avprediction`` apps and the three evals, data parallel
and sharded over GPUs (``parallel/``), on synthetic clips or media files
decoded in worker processes (``data/``).
"""

__version__ = "0.1.0"
