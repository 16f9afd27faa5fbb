"""The comparison that decides `correct`, at a size the CPU holds, with each cell's own
limits: sound runs of the port pass; the control (the reference in bfloat16 put in the
program's place) and runs with the timed path broken underneath fail. The card's
readings at the cells' own sizes are in limits/<cell>.json and PERF.md."""

import time
from pathlib import Path

import pytest
import torch

from bench_port import harness
from bench_port.drivers import render as render_driver
from bench_port.drivers import train as train_driver
from bench_port.reference import Precision
from bench_port.run import run
from langsplat_tpu_torch.core import losses
from langsplat_tpu_torch.train import trainer

HERE = Path(__file__).resolve().parent
CPU = torch.device("cpu")
SEED = 2**31 + 911
TRAIN = [("train-a.lerf-1m", "tiny_box.json"),
         ("train-a.synthroom-15k", "tiny_synthroom.json"),
         ("train-b.synthroom-15k", "tiny_synthroom.json")]
ALL = TRAIN + [("render.lerf-1m", "tiny_box.json")]


def tiny(cell_name: str, config: str):
    """The cell at a toy size; the render cell checks the first call's view, so that a
    short window on a loaded CPU still holds it."""
    cell = harness.load_cell(cell_name, config_file=str(HERE / config))
    cell.mix.update(traced_steps=2, checked_views=1, traced_views=1)
    return cell


def run_cell(cell):
    seconds = 1.0 if cell.mix["kind"] == "render" else 0.2
    return run(cell, SEED, seconds, False, CPU, time.perf_counter())


@pytest.mark.parametrize("cell_name,config", ALL)
def test_sound_runs_are_correct(cell_name, config):
    result = run_cell(tiny(cell_name, config))
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("cell_name,config", ALL)
def test_the_control_is_not_correct(cell_name, config):
    cell = tiny(cell_name, config)
    r = harness.driver(cell).Run(cell, SEED, CPU)
    ref = r.reference()
    correct, checks = harness.judge(r.compare(r.reference(Precision("bfloat16")), ref),
                                    cell.limits)
    assert not correct, checks


@pytest.mark.parametrize("cell_name,config", TRAIN)
def test_a_step_that_returns_its_state_unchanged_is_not_correct(cell_name, config,
                                                                monkeypatch):
    for name in ("train_step_rgb", "train_step_feature"):
        real = getattr(trainer, name)

        def unchanged(field, opt_state, stats, *args, _real=real, **kw):
            out = _real(field, opt_state, stats, *args, **kw)
            return out._replace(field=field, opt_state=opt_state, stats=stats)

        monkeypatch.setattr(train_driver.trainer, name, unchanged)
    result = run_cell(tiny(cell_name, config))
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell_name,config", TRAIN)
def test_a_loss_over_half_the_batch_is_not_correct(cell_name, config, monkeypatch):
    """The mean taken over the upper half of the image rows alone."""
    def half(x):
        return x[..., : x.shape[-2] // 2, :]

    l1, ssim, masked = losses.l1_loss, losses.ssim, losses.masked_l1_loss
    monkeypatch.setattr(losses, "l1_loss", lambda a, b: l1(half(a), half(b)))
    monkeypatch.setattr(losses, "ssim", lambda a, b, **kw: ssim(half(a), half(b), **kw))
    monkeypatch.setattr(losses, "masked_l1_loss",
                        lambda a, b, m: masked(half(a), half(b), half(m)))
    result = run_cell(tiny(cell_name, config))
    assert not result["correct"], result["checks"]


def test_an_answer_altered_where_it_is_produced_is_not_correct(monkeypatch):
    """One pixel of each rendered image off by 0.05."""
    real = render_driver.render_full

    def altered(*args, **kw):
        out = real(*args, **kw)
        out["render"] = out["render"].clone()
        out["render"][1, 5, 7] += 0.05
        return out

    monkeypatch.setattr(render_driver, "render_full", altered)
    result = run_cell(tiny("render.lerf-1m", "tiny_box.json"))
    assert not result["correct"], result["checks"]
