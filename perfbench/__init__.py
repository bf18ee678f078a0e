"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one
command runs one cell once (``python perfbench/run.py --workload <name>
--seed <n> --seconds <s> --trace <0|1>``)."""
