"""Hand-written Hopper kernels and their plain PyTorch twins.

Each wrapper takes the plain version for CPU tensors and launches its CUDA
kernel for CUDA tensors (raising on anything the kernel does not take);
there is no fallback between the two.  `launch_counts` holds one plain
integer per wrapper, raised by one at each kernel launch and nowhere else.
"""

from .rel_attention import (banded_rel_attention,
                            banded_rel_attention_plain)
from .resblock import (fused_resblock, fused_stage, pack_stage, stage_plain,
                       stage_weights)
from .tf32 import matmul_3xtf32, tf32_round, tf32_split
from .counts import launch_counts, reset_launch_counts

__all__ = ["banded_rel_attention", "banded_rel_attention_plain",
           "fused_resblock", "fused_stage", "pack_stage", "stage_plain",
           "stage_weights", "matmul_3xtf32", "tf32_round", "tf32_split",
           "launch_counts", "reset_launch_counts"]
