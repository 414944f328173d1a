"""The work counters against values worked out by hand on small cases."""
import math

import torch

from benchmark import counts, scene
from benchmark.reference import render


def test_field_flops_by_hand():
    # PE(x, 1): 3 + 6 = 9; Blender time net PE(t, 6) = 13 -> 256 -> 30;
    # in = 39; trunk (39->8), (8->8), skip after layer 1: (8+39 -> 8);
    # heads 8 -> 3, 4, 3
    field = {"kind": "baseline", "D": 3, "W": 8, "multires": 1,
             "is_blender": True, "skip": 1}
    macs = 13 * 256 + 256 * 30 + 39 * 8 + 8 * 8 + 47 * 8 + 8 * (3 + 4 + 3)
    assert counts.field_flops(field, 5) == 2 * 5 * macs
    ode = dict(field, kind="ode")
    assert counts.field_flops(ode, 1) == 2 * (macs - 8 * 7)


def test_ode_evals():
    assert counts.ode_evals([0.0, 0.5], 8) == 32
    assert counts.ode_evals([0.0, 0.0], 8) == 0
    assert counts.ode_evals([0.1, 0.2, 0.2, 0.9], 4) == 32


def test_blend_least():
    t, bound = counts.blend_least_s(10 ** 9, 100, 100, backward=False)
    assert bound == "ops" and t == 25e9 / 67e12
    t, bound = counts.blend_least_s(0, 10 ** 6, 10 ** 6, backward=True)
    assert bound == "bytes"
    assert t == (2 * 40e6 + 12e6) / 3.35e12


def _one_gaussian(opacity, var):
    """One isotropic splat at pixel (8, 8) of a 16x16 image."""
    rec = torch.tensor([[8.0, 8.0, 1 / var, 0.0, 1 / var, 1.0, 0.5, 0.25,
                         opacity, 1.0]])
    rect = torch.tensor([[0, 0, 1, 1]])
    return render.Splats(rec, rect, torch.tensor([True]))


def test_pairs_by_hand():
    # alpha = 0.5 e^(-d^2 / 8) >= 1/255 where d^2 <= 8 ln(127.5)
    sp = _one_gaussian(0.5, 4.0)
    img, pairs = render.image(sp, 16, 16, torch.zeros(3))
    r2 = 8 * math.log(127.5)
    want = sum(1 for x in range(16) for y in range(16)
               if (x - 8) ** 2 + (y - 8) ** 2 <= r2)
    assert pairs == want
    assert abs(float(img[8, 8, 0]) - 0.5) < 1e-6


def test_pairs_stop_at_the_cutoff():
    # two opaque splats (alpha clamps at 0.99): T after the second is
    # 1e-4 (kept), a third takes it under the cutoff and is not composited
    rec = torch.tensor([[8.0, 8.0, 1e-6, 0.0, 1e-6, 1, 1, 1, 1.0, z]
                        for z in (1.0, 2.0, 3.0)])
    sp = render.Splats(rec, torch.tensor([[0, 0, 1, 1]] * 3),
                       torch.tensor([True] * 3))
    _, pairs = render.image(sp, 16, 16, torch.zeros(3))
    keep = 1 - torch.tensor(0.99)
    t2 = float(keep * keep)
    assert pairs == 256 * (2 if t2 >= 1e-4 else 1)


def test_scene_is_the_seeds():
    g1 = scene.generator(2 ** 31 + 5, "cpu")
    g2 = scene.generator(2 ** 31 + 5, "cpu")
    a, alive = scene.gaussians(50, 1024, 3, g1, "cpu")
    b, _ = scene.gaussians(50, 1024, 3, g2, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert int(alive.sum()) == 50
    assert float(a["xyz"][:50].abs().max()) <= 1.3
