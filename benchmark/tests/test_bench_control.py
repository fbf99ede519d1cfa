"""The control, the reference computed with float8 products put in the
program's place, fails where the program (bf16) passes: at tiny sizes on
the CPU against limits set at those sizes (``tiny.TINY_LIMITS``); on the
card at the cells' own sizes against their own limits (``chip``, three
seeds a cell)."""

import pytest

from benchmark import check, harness
from benchmark.calibrate import readings
from benchmark.tiny import TINY_LIMITS, tiny_config

CELLS = ["clip_b32_train", "vit_b16_train", "vit_b16_eval", "clip_b32_zeroshot"]


def _judge(name, device, seed, cfg, limits):
    got, _ = readings(name, seed, ["program", "control"], device, cfg)
    return check.judge(got["program"], limits)[0], check.judge(got["control"], limits)[0]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_the_program_passes(name):
    cfg = tiny_config(harness.workload(harness.manifest(), name)["config"])
    program_ok, control_ok = _judge(name, "cpu", 12, cfg, TINY_LIMITS[name])
    assert program_ok and not control_ok


@pytest.mark.chip
@pytest.mark.parametrize("seed", [2 ** 31 + 4, 2 ** 31 + 5, 2 ** 31 + 6])
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_the_program_passes_on_the_card(name, seed, card):
    limits = harness.load_json(harness.HERE, "limits", f"{name}.json")
    program_ok, control_ok = _judge(name, card, seed, None, limits)
    assert program_ok and not control_ok
