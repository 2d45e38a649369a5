"""PyTorch + CUDA port of radialog_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's layout (ops/, models/, decode/, apps/). The TPU's
Pallas kernels on the serving path are hand-written CUDA kernels under
csrc/, built with nvcc at first use (ops/_build.py). Entry points run on
the card ("cuda") unless the caller passes a CPU device, as the tests do;
on CPU tensors each kernel wrapper runs its plain PyTorch version.
"""
