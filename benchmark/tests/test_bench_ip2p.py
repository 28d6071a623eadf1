"""The InstructPix2Pix cell's files: what its modules import, its driver
on a tiny configuration on the CPU (sound, then the two controls), and
the `span_roofline` kind."""

import pytest

from benchmark import counts, run, workload
from benchmark.ext import ip2p_edit as ip2p
from conftest import tiny_cell
from test_bench_imports import BENCH, FORBIDDEN, PROGRAM, top_level_imports


@pytest.mark.parametrize("name", ["ip2p_edit.py", "ip2p_reference.py"])
def test_no_jax(name):
    assert not top_level_imports(BENCH / "ext" / name) & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    assert PROGRAM not in top_level_imports(BENCH / "ext" /
                                            "ip2p_reference.py")


def tiny(**over):
    """ip2p-edit1m at the tiny cell's size, the UNet and the VAE cut to
    a few channels (an 8x8 latent) in float32."""
    cell = tiny_cell("ip2p-edit1m", **over)
    g = cell.cfg["guidance"]
    g["unet"].update(block_out_channels=[32, 64, 64], cross_attention_dim=16,
                     attention_head_dim=2, norm_num_groups=8)
    g["vae"].update(block_out_channels=[16, 16, 32, 32], layers_per_block=1,
                    norm_num_groups=8)
    g["unet_dtype"] = g["vae_dtype"] = "float32"
    return cell


def judged(cell):
    r = workload.driver(cell.traffic["driver"])(cell)
    optional = run.load("cells", cell.name).get("optional", ())
    return r, run.judge(r, cell.limits, optional)[0]


def test_a_sound_run_is_correct_and_holds_whole_cycles():
    r, ok = judged(tiny())
    assert ok, r.checks
    assert r.steps > 0 and r.steps % 10 == 0
    assert r.info["refreshes_scheduled"] == 2 * r.steps // 10
    assert r.info["unet_evals_scheduled"] == 20 * r.info[
        "refreshes_scheduled"]
    assert r.extra_least_s > 0


@pytest.mark.parametrize("control", ["bf16", "drop_step"])
def test_the_controls_are_not_correct(control, monkeypatch):
    monkeypatch.setattr(ip2p, "CONTROL", control)
    cell = tiny(window=False, control=True)
    r, ok = judged(cell)
    assert not ok, r.checks
    if control == "drop_step":      # the first UNet call is sound
        assert r.checks["unet_gap"] <= cell.limits["unet_gap"]


class _Spans:
    def __init__(self, ms):
        self.ms = ms

    def device_ms(self, name):
        return self.ms if name == "ip2p.unet" else 0.0


def test_span_roofline():
    work = [dict(height=512, width=512), dict(height=512, width=256)]
    m = {"kind": "span_roofline", "span": "ip2p.unet", "count": "unet",
         "times": "unet_evals_scheduled"}
    r = workload.Run(work=work, info={"unet_evals_scheduled": 40})
    r.spans = _Spans(200.0)
    least = 40 * (ip2p.unet_least_s(work[0]) + ip2p.unet_least_s(work[1])) / 2
    kind = run.kind("span_roofline")
    assert kind(r, m) == pytest.approx(100.0 * least / 0.2)
    assert counts.kernel("unet") is ip2p.unet_least_s
    assert kind(workload.Run(work=work), m) is None          # no trace
    r.spans = _Spans(0.0)
    assert kind(r, m) is None                                 # no device time
    r.spans, r.info = _Spans(200.0), {}
    assert kind(r, m) is None                                 # no window


def test_the_least_times_at_the_published_size():
    w = dict(height=512, width=512)
    # 2.41 TFLOP a batch-3 UNet call, 1.12 an encode, 2.51 a decode
    assert ip2p.unet_least_s(w) == pytest.approx(2.41010343936e12 / 989.4e12)
    assert ip2p.vae_least_s(w) == pytest.approx(
        (2 * 1.116658466816e12 + 2.514518933504e12) / 989.4e12)
