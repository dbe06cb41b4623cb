"""The benchmark of the PyTorch + CUDA port (`xfmr_rec_torch`) on NVIDIA H100s.

`python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once (`run.py`).
"""
