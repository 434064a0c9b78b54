"""The yardstick's counts follow the frame, the mesh and the batch, and
nothing of the program's own byte counters."""

import ast

import pytest
import torch

from portbench import roofline
from portbench.tests.conftest import ROOT

W = roofline.Work(batch=2, vertices=10, triangles=16, covered=100.0, silhouette=20.0,
                  channels=3, optimizer="adam")


def test_counts_of_a_tiny_problem_by_hand():
    mesh = 24 * 10 + 12 * 16 + 2 * 28 * 2
    assert roofline.raster(W) == (mesh + 2 * 100 * 20, 2 * (48 * 10 + 94 * 16 + 40 * 100))
    assert roofline.loss(W) == (16 * 100 + 2 * 100 * 16, 2 * 2 * (27 * 100 + 10 * 20))
    b, ops = roofline.step(W)
    assert b == 16 * 100 + mesh
    assert ops == roofline.raster(W)[1] + roofline.loss(W)[1] + 12 * 7 * 2


@pytest.mark.parametrize("job", [roofline.raster, roofline.loss, roofline.step])
def test_counts_follow_the_batch_the_mesh_and_the_frame(job):
    import dataclasses

    base = job(W)
    twice = job(dataclasses.replace(W, batch=4))
    assert twice[1] > base[1] and twice[0] >= base[0]
    bigger = job(dataclasses.replace(W, covered=400.0, silhouette=40.0))
    assert bigger[1] > base[1] and bigger[0] > base[0]
    if job is not roofline.loss:
        assert job(dataclasses.replace(W, triangles=64, vertices=40))[1] > base[1]


def test_least_time_takes_the_larger_bound_and_unknown_chips_read_nothing():
    bw, flops = roofline.PEAKS["NVIDIA H100 80GB HBM3"]
    assert roofline.least_seconds((bw, 0.0), "NVIDIA H100 80GB HBM3") == pytest.approx(1.0)
    assert roofline.least_seconds((0.0, 2 * flops), "NVIDIA H100 80GB HBM3") == pytest.approx(2.0)
    assert roofline.least_seconds((1.0, 1.0), "some other card") is None


def test_coverage_counts_pixels_and_silhouette_pairs():
    seg = torch.zeros((1, 3, 4, 5))
    seg[0, :, 1:3, 1:3] = 1.0  # a 2 x 2 square: 4 pixels, 8 pairs across its edge
    assert roofline.coverage(seg) == (4.0, 8.0)


def test_the_yardstick_reads_nothing_of_the_program():
    tree = ast.parse((ROOT / "portbench" / "roofline.py").read_text())
    names = {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    names |= {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    assert not any(str(n).split(".")[0].startswith("diffdope") for n in names)
