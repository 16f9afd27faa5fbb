"""The benchmark's plain reference against the port's CPU path (its plain kernels) at a
toy size: the camera matrices, the binned instances, a render, and three training steps
of each phase."""

import math
from pathlib import Path

import pytest
import torch

from bench_port import harness, scenes
from bench_port.drivers import program
from bench_port.reference import geometry, raster
from bench_port.reference import train as ref_train
from langsplat_tpu_torch.ops import projection
from langsplat_tpu_torch.ops.tiles import bin_gaussians
from langsplat_tpu_torch.train.loop import render_full

HERE = Path(__file__).resolve().parent
CPU = torch.device("cpu")


def tiny(cell_name: str, config: str):
    return harness.load_cell(cell_name, config_file=str(HERE / config))


@pytest.fixture(scope="module")
def box():
    cell = tiny("render.lerf-1m", "tiny_box.json")
    scene = scenes.make(cell.config, 5, CPU)
    return cell, scene


def test_camera_matrices_equal_the_ports(box):
    _, scene = box
    for cam, (rot, t) in zip(program.cameras(scene), scene.poses):
        view = geometry.view_of(rot, t, scene.fov_x, scene.fov_y, scene.width,
                                scene.height, CPU)
        assert torch.equal(view.viewmatrix, torch.as_tensor(cam.world_view_transform))
        assert torch.equal(view.projmatrix, torch.as_tensor(cam.full_proj_transform))
        assert torch.equal(view.campos, torch.as_tensor(cam.camera_center))


def test_instances_equal_the_ports_binning(box):
    cell, scene = box
    leaves = scene.leaves
    rot, t = scene.poses[0]
    view = geometry.view_of(rot, t, scene.fov_x, scene.fov_y, scene.width, scene.height,
                            CPU)
    shs = torch.cat([leaves["f_dc"], leaves["f_rest"]], dim=1)
    prep = geometry.project(leaves["xyz"], torch.exp(leaves["scaling"]),
                            leaves["rotation"], shs, leaves["alive"], view, 3, 16)
    opac = torch.sigmoid(leaves["opacity"])[:, 0]
    ref = raster.bin_instances(prep, opac, scene.width, scene.height, 16)
    port_prep = projection.preprocess(
        leaves["xyz"], torch.exp(leaves["scaling"]), leaves["rotation"], shs,
        view.viewmatrix, view.projmatrix, view.campos, image_height=scene.height,
        image_width=scene.width, tanfovx=view.tanfovx, tanfovy=view.tanfovy,
        sh_degree=3, tile_size=16, alive=leaves["alive"])
    for a, b in zip(prep, port_prep):
        assert torch.equal(a, b)
    inst = bin_gaussians(port_prep, grid_x=4, grid_y=3, budget=1 << 16,
                         max_tiles_per_gaussian=12, tile_size=16, opacities=opac)
    count = int(inst.num_instances)
    assert ref.count == count > 0
    assert torch.equal(ref.gauss_id, inst.gauss_id[:count].to(torch.int64))
    assert torch.equal(ref.tile_start, inst.tile_start.to(torch.int64))


def test_render_matches_render_full(box):
    cell, scene = box
    field = program.field_of(scene.leaves)
    pipe = program.pipeline(cell.config)
    for v, cam in enumerate(program.cameras(scene)):
        out = render_full(field, cam, pipe, 3, True, [0.0, 0.0, 0.0], device="cpu")
        rot, t = scene.poses[v]
        ref = ref_train.render_view(scene.leaves, geometry.view_of(
            rot, t, scene.fov_x, scene.fov_y, scene.width, scene.height, CPU),
            sh_degree=3, tile_size=16, include_feature=True)
        assert ref["pairs"][1] > 0
        for key, ref_key in (("render", "render"), ("language_feature_image", "features"),
                             ("final_transmittance", "t_final")):
            assert float((out[key] - ref[ref_key]).abs().max()) < 1e-6


@pytest.mark.parametrize("cell_name,config", [
    ("train-a.lerf-1m", "tiny_box.json"),
    ("train-a.synthroom-15k", "tiny_synthroom.json"),
    ("train-b.synthroom-15k", "tiny_synthroom.json"),
])
def test_training_steps_match_the_ports(cell_name, config):
    """Three steps of the port's trainer (its plain kernels on the CPU), read as a
    benchmark run reads them, against the reference's three steps from the seed."""
    cell = tiny(cell_name, config)
    run = harness.driver(cell).Run(cell, 2**31 + 77, CPU)
    numbers = run.compare(run.program, run.reference())
    assert set(numbers) == {"loss_gap", "grad_gap", "change_gap"}
    assert all(0 <= v < 1e-5 for v in numbers.values()), numbers
    assert all(math.isfinite(x) and x > 0 for x in run.program["losses"])
