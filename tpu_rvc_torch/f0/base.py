"""f0 constants (tpu_rvc/f0/base.py:14-15; reference rvc/f0/gen.py)."""

F0_MIN = 50.0
F0_MAX = 1100.0
