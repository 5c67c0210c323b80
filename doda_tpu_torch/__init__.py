"""PyTorch/CUDA port of ``doda_tpu``: the eval forward of the sparse U-Net.

Module names mirror ``doda_tpu`` so each counterpart is easy to find. The
package imports ``torch`` and ``numpy`` only; its CUDA kernels build from
``csrc/`` at first use (``ops/_build.py``).
"""
