"""chip_smoke.py on the CPU: the script refuses to run without a GPU, and
its phase functions (headline, chain parity, residual parity) pass at a
tiny size."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def test_main_exits_nonzero_without_gpu(monkeypatch, capsys):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_phases_refuse_cpu_backend():
    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.run_phases()


def test_phase_headline_tiny():
    fixed, conv = chip_smoke.phase_headline("cpu", elements=64, reps=1)
    assert fixed["ok"] and conv["ok"]
    assert fixed["wall"]["reps"] == 1
    assert fixed["memory"]["output_size_in_bytes"] > 0


def test_phase_chain_parity_tiny():
    res = chip_smoke.phase_chain_parity("cpu", elements=64)
    assert set(res) == {"default", "highest"}


def test_phase_residual_parity_tiny():
    res = chip_smoke.phase_residual_parity("cpu", elements=64)
    assert res["residual"] < chip_smoke.RESIDUAL_TOL
