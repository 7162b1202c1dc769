"""The benchmark of ``range_coder_rust_tpu_torch``: ``python3 -m rc_bench
--workload <cell> --seed <n> --seconds <s> --trace <0|1>`` (``README.md``)."""
