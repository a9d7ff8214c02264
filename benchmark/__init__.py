"""The benchmark of the PyTorch and CUDA port
(``event_based_optical_flow_tpu_torch``): ``python benchmark/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>`` runs one cell of
``BENCHMARK.json`` once on the card and prints its result as the last line
of standard output."""
