"""The port's command line on the CPU at a small preset: the MPC server
(cli.mpc_server_main: every solve succeeds and the statistics come back)
and run-motion (cli.run_motion_main: the JAX CLI's files)."""
import json
import math

import numpy as np
import pytest
import torch

import torch_parity_util
from centroidal_mpc_tpu_torch import cli
from centroidal_mpc_tpu_torch.utils.artifacts import ArtifactStore


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


@pytest.mark.parametrize("terrain", ["flat", "debris"])
def test_run_motion_writes_the_jax_cli_files(tmp_path, terrain, capsys):
    """run-motion --cpu on the mini preset with 2 physics episodes writes
    the files the JAX package's run-motion writes for the same command
    (scripts/jax_physics_reference.py): the same artifacts with the same
    npz keys and shapes and .dat shapes, the figures and the preview."""
    argv = ["--cpu", "--preset", "solo12_trot_mini", "--sims", "2",
            "--physics-sims", "2", "--out", str(tmp_path)]
    if terrain == "debris":
        argv += ["--terrain", "debris"]
    res = cli.run_motion_main(argv)
    want = json.loads(str(np.load(torch_parity_util.PHYSICS_REF)[
        f"manifest_mini_{terrain}"]))
    assert ArtifactStore(tmp_path).manifest() == want
    out = capsys.readouterr().out
    for tag in ("[pipeline]", "[nominal]", "[stochastic]", "[monte-carlo]",
                "[physics mc]", "[preview]", "[artifacts]"):
        assert tag in out, tag
    assert "device=cpu dtype=float32" in out
    assert (res.terrain is None) == (terrain == "flat")
    assert bool(res.nominal.success[0]) and bool(res.stochastic.success[0])


def test_run_motion_needs_a_card_or_cpu_flag():
    """Without --cpu run-motion runs on the card, and raises where there
    is none, never falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the chip smoke drives run-motion")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.run_motion_main(["--preset", "solo12_trot_mini"])


def test_main_dispatches_commands(capsys):
    assert cli.main([]) == 2
    assert "run-motion" in capsys.readouterr().err
    assert set(cli.COMMANDS) == {"run-motion", "mpc-server"}
