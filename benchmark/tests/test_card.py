"""On the card, at each cell's own size: each control comes out not
correct on three seeds (the reference in the program's place with
float8 operands in its text encoders and UNet, one precision below the
configuration's bf16, and the program's own bf16 decode, one below the
decode's fp32), and the program's sound runs on the same seeds correct.

    python -m pytest benchmark/tests/test_card.py -m cuda

About five minutes a cell on one H100; skips without a card.
"""

import pytest
import torch

from benchmark.tests import readings

SEEDS = (2718281828, 3141592653, 1414213562)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["omg2_latency_1024",
                                  "t2i_lora1_batch4_1024"])
def test_the_controls_fail_and_the_program_passes(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run at SDXL's size")
    sound = readings.readings(cell, SEEDS)
    assert all(r["correct"] for r in sound), sound
    assert not any(r["fp8_reference_correct"] for r in sound), sound
    lines = readings.readings(cell, SEEDS, control="bf16_decode")
    assert not any(r["correct"] for r in lines), lines
