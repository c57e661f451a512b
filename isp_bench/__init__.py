"""The benchmark of pysp_tpu_torch: ``python3 isp_bench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>`` (see ``harness.py``)."""
