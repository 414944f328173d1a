"""The benchmark of d3gs_tpu_torch, the PyTorch and CUDA port.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the repository root on a machine with a CUDA card. Everything a
cell needs is found by name from `BENCHMARK.json`: its configuration in
`configs/<config>.json`, its traffic in `mixes/<traffic>.json` (which names
the loop of `loops/` that drives it), its correctness limits in
`limits/<cell>.json`, and one reader per metric in `metrics/<metric>.py`.
`reference/` is the plain PyTorch reference that decides `correct`; it
imports nothing of the program.
"""
