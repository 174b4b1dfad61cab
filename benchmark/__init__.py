"""The benchmark of `feddlib_tpu_torch` on one NVIDIA H100: closed loops of
operations a user pays for, driven by `BENCHMARK.json` and the files under
this directory (`python3 -m benchmark.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`)."""
