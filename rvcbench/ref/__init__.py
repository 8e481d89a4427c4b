"""The plain reference that decides `correct`.

Frozen copies of the port's plain PyTorch modules (HuBERT, RMVPE and its
decode, the synthesizer with the kernels' functions written as plain
convolutions and banded attention, the state-dict converters) and the
conversion steps written out again (`offline.py`, `stream.py`).  Nothing
here imports the program: it reads the weights and inputs the benchmark
made, never what the program derived from them.  Its precision is set by
the caller (`precision.py`).
"""
