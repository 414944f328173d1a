"""Trainers (counterpart of `d3gs_tpu/train/`): the shared train step
(`step.py`) and the baseline trainer (`baseline.py`). `python -m
d3gs_tpu_torch.train` is the CLI (`__main__.py`)."""
