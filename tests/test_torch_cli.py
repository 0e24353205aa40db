"""The port's MPC server (cli.mpc_server_main) on the CPU at a small
preset: every solve succeeds and the statistics come back."""
import math

import pytest
import torch

from centroidal_mpc_tpu_torch import cli


def test_mpc_server_runs_on_cpu():
    stats = cli.mpc_server_main(["--cpu", "--preset", "solo12_trot_mini",
                                 "--ticks", "50", "--resolves", "1"])
    assert stats["device"] == "cpu"
    assert len(stats["solve_times_s"]) == 1 and all(stats["successes"])
    assert stats["ticks"] == 50 == len(stats["track_err"])
    assert all(math.isfinite(e) for e in stats["track_err"])
    assert stats["max_late_ns"] >= 0


def test_mpc_server_needs_a_card_or_cpu_flag():
    """Without --cpu the server runs on the card, and raises where there
    is none, never falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the chip smoke drives the server")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.mpc_server_main(["--preset", "solo12_trot_mini", "--ticks",
                             "1", "--resolves", "1"])
