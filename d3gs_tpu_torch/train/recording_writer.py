"""A stand-in for `torch.utils.tensorboard.SummaryWriter` that records the
calls the trainers make (their `tb_writer` argument), to check the tags,
steps and shapes they log without tensorboard."""
from __future__ import annotations

import numpy as np


class RecordingWriter:
    """`events`: ("scalar" | "histogram", tag, step, shape) and ("image",
    tag, step, shape, dataformats), in call order; `scalars`: each scalar
    tag's values."""

    def __init__(self):
        self.events = []
        self.scalars = {}

    def add_scalar(self, tag, value, step):
        self.scalars.setdefault(tag, []).append(float(value))
        self.events.append(("scalar", tag, int(step), ()))

    def add_histogram(self, tag, values, step):
        self.events.append(("histogram", tag, int(step), np.shape(values)))

    def add_image(self, tag, img, step, dataformats="CHW"):
        self.events.append(("image", tag, int(step), np.shape(img),
                            dataformats))
