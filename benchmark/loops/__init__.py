"""The loops that drive a cell's window, one module per kind of traffic:
a mix's data file names its loop (`"loop": "train"` -> `loops/train.py`).
Each module has `Loop(cfg, mix, seed, device)` with `setup()`,
`window(seconds, traced)` -> readings, `finish(traced)` -> the traced
run's further readings, `release()`, `check()` -> the numbers compared,
and `reference(tf32)` / `numbers(prog, ref)`, which `check` and the
calibration use."""
