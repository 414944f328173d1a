"""Trainers (counterpart of `d3gs_tpu/train/`): the shared train step
(`step.py`), the baseline (`baseline.py`) and flagship (`flagship.py`)
trainers, trajectory distillation (`distill.py`) and the synthetic-ODE
harness (`synth_ode.py`). `python -m d3gs_tpu_torch.train` is the CLI
(`__main__.py`)."""
