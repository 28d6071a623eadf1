"""A run with the timed path broken underneath comes out not correct:
each fault a cell can have, on the CPU at a tiny size (the look for a
chip skipped). The sound run, at the same size, comes out correct."""

import numpy as np
import pytest

from benchmark import run, workload
from conftest import tiny_cell


def correct(cell):
    r = workload.driver(cell.traffic["driver"])(cell)
    optional = run.load("cells", cell.name).get("optional", ())
    return run.judge(r, cell.limits, optional)[0]


@pytest.mark.parametrize("name", ["edit1m", "garden-late", "webui-edit1m"])
def test_sound_runs_are_correct(name):
    assert correct(tiny_cell(name))


def test_the_web_ui_is_correct_after_densify_events():
    """Frames of a served scene whose densify events wrote new slots:
    every third step from step 3, past the steps the reference follows."""
    cell = tiny_cell("webui-edit1m", seconds=3.0)
    cell.cfg["train"]["densification_interval"] = 3
    cell.cfg["train"]["densify_grad_threshold"] = 0.0
    assert correct(cell)


@pytest.mark.parametrize("name", ["edit1m", "garden-late"])
def test_a_step_that_leaves_the_state_unchanged(name, monkeypatch):
    from gaussianeditor_tpu_torch.train import optim

    def no_step(self, params, grads, state, **kw):
        state.count += 1
        return state

    monkeypatch.setattr(optim.GaussianAdam, "step", no_step)
    assert not correct(tiny_cell(name))


@pytest.mark.parametrize("name", ["edit1m", "webui-edit1m"])
def test_half_the_batch_left_out(name, monkeypatch):
    from gaussianeditor_tpu_torch.edit import edit_system

    make = edit_system.make_train_step

    def half(*a, **k):
        step = make(*a, **k)

        def train_step(state, cams, targets, *rest, **kw):
            h = len(cams) // 2
            return step(state, cams[:h], targets[:h], *rest, **kw)

        return train_step

    monkeypatch.setattr(edit_system, "make_train_step", half)
    assert not correct(tiny_cell(name))


def test_a_frame_altered_where_it_is_made(monkeypatch):
    from gaussianeditor_tpu_torch.apps import webui

    encode = webui.encode_png

    def altered(img):
        img = np.array(img)
        img[:8, :8] = 255 - img[:8, :8]
        return encode(img)

    monkeypatch.setattr(webui, "encode_png", altered)
    assert not correct(tiny_cell("webui-edit1m"))


def test_a_frame_of_a_torn_scene(monkeypatch):
    """A publish that copies half the scene's tensors: the frames show a
    scene that no step published."""
    from gaussianeditor_tpu_torch.apps import webui

    def torn(self, src):
        with self.lock:
            for dst, new in list(zip(webui._scene_tensors(self.scene),
                                     webui._scene_tensors(src)))[:3]:
                dst.data.copy_(new.data)

    monkeypatch.setattr(webui.WebUIState, "_publish", torn)
    assert not correct(tiny_cell("webui-edit1m"))
