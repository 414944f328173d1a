"""Gaussian-trajectory forecasting (counterpart of `d3gs_tpu/forecast/`)."""
from .model import TrajectoryForecaster, forecaster_from_flax  # noqa: F401
from .train import (evaluate_forecaster, forecast, make_windows,  # noqa: F401
                    train_forecaster)
