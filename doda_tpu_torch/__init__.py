"""PyTorch/CUDA port of ``doda_tpu``: the sparse U-Net's eval, train and
self-training steps, the data path and the train/test/st CLIs.

Module names mirror ``doda_tpu`` so each counterpart is easy to find. The
package imports ``torch`` and ``numpy`` (and scipy/PyYAML where a data
module needs them), never JAX; its CUDA kernels build from ``csrc/`` and
its host library from ``native/src/`` at first use (``ops/_build.py``).
"""
