"""tpu_rvc_torch — the PyTorch / CUDA port of tpu_rvc for NVIDIA Hopper.

The JAX package `tpu_rvc` is the reference; this package keeps its module
tree and names (`nn/attention.py` <-> `nn/attention.py`) and its public
layouts (features (B, T, C), audio (B, T)), and never imports JAX or
anything under `tpu_rvc`.

Entry points (`VC`, `Pipeline`, the model builders) take a `device`
argument.  Without one they run on "cuda" and raise when CUDA is absent;
the CPU is used only when the caller asks for it.  The Pallas kernels of
the JAX package are hand-written CUDA C++ here (`csrc/`), built with nvcc
at first use into `build/kernels/`; each has a plain PyTorch twin in the
same module, which runs for CPU tensors only.
"""

__version__ = "0.1.0"
