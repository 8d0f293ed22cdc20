"""The benchmark of distributed_tf_serving_tpu_torch: `python3 ctrbench/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>`."""
