"""What the work is, counted from the equations and the shapes, and the
card's peaks: the yardstick of the roofline and mfu metrics.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense): 67 TFLOP/s in
float32 outside the tensor cores (the configurations are float32 with
TF32 off) and 3.35 TB/s of HBM3, at the 700 W power limit.

Operations count an add, a multiply, a compare, an exp or a log as one
each, a fused multiply-add as two.
"""
from __future__ import annotations

from .reference.fields import layer_shapes

F32_PEAK_FLOPS = 67e12
HBM_PEAK_BYTES = 3.35e12

# one composited (pixel, Gaussian) pair, forward (reference/render.py):
# dx, dy (2); power = -0.5 (a dx dx + c dy dy) - b dx dy (9); alpha =
# opacity e^power and its clamp (3); the 1/255 test (1); T_after = T (1 -
# alpha) (2); the cutoff test (1); w = T alpha (1); colour += w rgb (6)
BLEND_FWD_OPS = 25
# the same pair walked back: power and alpha again (14); T before it from
# T after (2); w (1); g_w = <g_image, rgb> (5); the suffix sum S += g_w w
# (2); g_alpha = g_w T - (S + g_T T_final) / (1 - alpha) (6); g_power =
# g_alpha alpha (1); d mean2d (8), d conic (7), d rgb (3), d opacity (2);
# the ten partials summed into the Gaussian's gradient (10)
BLEND_BWD_OPS = 61
RECORD_BYTES = 10 * 4          # mean2d, conic, rgb, opacity, depth
SH_OPS = 137                   # degree 3: 16 basis values, 48 FMAs, clamp
PROJECTION_OPS = 211           # two 4x4 transforms, J W R S, cov, conic
LOSS_OPS = 241                 # per pixel and channel: L1, five 11-tap
#                                separable blurs, SSIM's formula
ADAM_OPS = 14                  # per parameter element
GAUSSIAN_FLOATS = 59           # 3 + 3 + 45 + 3 + 4 + 1 at SH degree 3


def field_flops(field: dict, points: int) -> float:
    """Matrix-product FLOPs of one forward evaluation over `points` (the
    time net included: the program evaluates it per point)."""
    return 2.0 * points * sum(i * o for i, o in layer_shapes(field))


def field_params(field: dict) -> int:
    return sum(i * o + o for i, o in layer_shapes(field))


def ode_evals(times, substeps: int) -> int:
    """Dynamics evaluations of a fixed-step RK4 through the sorted
    `times`: 4 per step, `substeps` steps per segment of non-zero
    length."""
    return sum(4 * substeps for a, b in zip(times[:-1], times[1:]) if a != b)


def blend_least_s(pairs: int, gaussians: int, pixels: int,
                  backward: bool) -> tuple[float, str]:
    """The least time of a blend over `pairs` composited pairs: the
    larger of its operations over the f32 peak and its bytes (the records
    read once and the image, or its cotangent and the records' gradient,
    written once) over the HBM peak; and which bound it is."""
    ops = pairs * (BLEND_BWD_OPS if backward else BLEND_FWD_OPS)
    nbytes = gaussians * RECORD_BYTES + pixels * 3 * 4
    if backward:
        nbytes += gaussians * RECORD_BYTES
    t_ops, t_bytes = ops / F32_PEAK_FLOPS, nbytes / HBM_PEAK_BYTES
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")


def view_flops(field: dict, gaussians: int, pixels: int, pairs: float,
               evals: float) -> float:
    """FLOPs of one viewer frame: the field (one MLP evaluation, or
    `evals` ODE evaluations), SH and projection of every Gaussian, the
    forward blend's pairs."""
    f = field_flops(field, gaussians) * (evals if field["kind"] == "ode"
                                         else 1)
    return f + gaussians * (SH_OPS + PROJECTION_OPS) + pairs * BLEND_FWD_OPS


def train_step_flops(field: dict, gaussians: int, pixels: int, views: int,
                     pairs: float, evals: float) -> float:
    """FLOPs of one training step over `views` views: forward and
    backward (three forwards) of the field (per view for the MLP, over
    `evals` evaluations for the ODE; recomputation not counted), of SH,
    projection and the losses, the blend's pairs both ways, and both
    Adams."""
    per_eval = field_flops(field, gaussians)
    f = 3 * per_eval * (evals if field["kind"] == "ode" else views)
    per_view = (3 * gaussians * (SH_OPS + PROJECTION_OPS)
                + 3 * pixels * 3 * LOSS_OPS)
    adam = ADAM_OPS * (gaussians * GAUSSIAN_FLOATS + field_params(field))
    return (f + views * per_view + pairs * (BLEND_FWD_OPS + BLEND_BWD_OPS)
            + adam)
