"""The benchmark of tpu_rvc_torch: `python3 rvcbench/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>` (see README.md here)."""
