"""The benchmark of the PyTorch and CUDA port (``mvlpt_torch``) on one
H100: ``python3 portbench/run.py --workload <cell> ...``."""
