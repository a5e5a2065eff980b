"""A short run of a cell at full size on the card (skipped without one):
``python -m pytest benchmark/tests -q -m card`` on the machine with the
card."""
from __future__ import annotations

import pytest

from benchmark import run


@pytest.mark.card
@pytest.mark.parametrize("cell", ["llavanext.pope_prefix", "bakllava.caption_exact_b64"])
def test_a_short_run_on_the_card_is_correct(cell, card):
    result = run.run(["--workload", cell, "--seed", "2147483659", "--seconds", "1", "--trace", "0"])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["memory_peak_bytes"] > 0
