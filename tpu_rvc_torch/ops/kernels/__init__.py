"""Hand-written Hopper kernels and their plain PyTorch twins.

Each wrapper takes the plain version for CPU tensors and launches its CUDA
kernel for CUDA tensors (raising on anything the kernel does not take);
there is no fallback between the two.  `launch_counts` holds one plain
integer per wrapper, raised by one at each kernel launch and nowhere else.
Inside `counting()` a wrapper neither launches nor runs its twin: it adds
its formula (`attention_flops`, `stage_flops`) to the count and returns
zeros, which is how `utils/roofline.py` counts the kernels it cannot see.
All of them are forward only, as the JAX kernels are (no VJP): with grad
mode on, an input that requires grad makes a wrapper raise on any device
(`refuse_grad`), and training runs the modules' differentiable branches.
"""

from .rel_attention import (attention_flops, banded_rel_attention,
                            banded_rel_attention_plain)
from .resblock import (fused_resblock, fused_stage, pack_stage, stage_flops,
                       stage_plain, stage_weights)
from .tf32 import matmul_3xtf32, tf32_round, tf32_split
from .counts import counting, launch_counts, reset_launch_counts

__all__ = ["attention_flops", "banded_rel_attention",
           "banded_rel_attention_plain", "fused_resblock", "fused_stage",
           "pack_stage", "stage_flops", "stage_plain", "stage_weights",
           "matmul_3xtf32", "tf32_round", "tf32_split", "counting",
           "launch_counts", "reset_launch_counts"]
