"""The benchmark of the PyTorch/CUDA port
(``cnns_slfp_quantization_tpu_torch``): ``python3 -m benchmark.run
--workload <cell> --seed <n> --seconds <s> --trace <0|1>``.  See
README.md."""
