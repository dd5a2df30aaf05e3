"""The H100 benchmark of the PyTorch and CUDA port (dirt_tpu_torch).

Run one cell from the checkout's root:

    python3 bench_h100/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""
