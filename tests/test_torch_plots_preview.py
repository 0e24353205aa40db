"""The port's figures (sim/plots.py), HTML motion preview (sim/preview.py)
and control-rate contact positions (contact/plan.interpolate_contact_
positions): tests/test_plots.py and tests/test_preview.py on the port,
the preview byte for byte against the JAX package's on the same inputs,
and the contact positions against the JAX package's."""
import json
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centroidal_mpc_tpu import presets as jpresets
from centroidal_mpc_tpu.contact.plan import (
    interpolate_contact_positions as jinterp)
from centroidal_mpc_tpu.sim import preview as jpreview
from centroidal_mpc_tpu_torch.config import presets
from centroidal_mpc_tpu_torch.contact import terrain as ter
from centroidal_mpc_tpu_torch.contact.plan import (
    interpolate_contact_positions)
from centroidal_mpc_tpu_torch.models import kinematics as kin
from centroidal_mpc_tpu_torch.sim import plots
from centroidal_mpc_tpu_torch.sim.preview import (_knee_positions,
                                                  motion_preview_html,
                                                  write_motion_preview)

import torch_parity_util  # noqa: F401  (one torch thread)


def _extract_data(html: str) -> dict:
    m = re.search(r"const D = (\{.*?\});\n", html, re.S)
    assert m, "embedded JSON payload not found"
    return json.loads(m.group(1))


def test_plot_foot_slippage(tmp_path):
    rng = np.random.default_rng(0)
    series = {
        "nominal": np.cumsum(rng.uniform(0, 1e-4, (5, 300)), axis=1),
        "stochastic": torch.as_tensor(
            np.cumsum(rng.uniform(0, 5e-5, (5, 300)), axis=1)),
    }
    fig = plots.plot_foot_slippage(series, 0.001, save_dir=tmp_path)
    assert fig is not None
    assert (tmp_path / "foot_slippage.png").exists()


def test_plot_whole_body_solution(tmp_path):
    t, nj = 200, 12
    rng = np.random.default_rng(1)
    q = rng.normal(size=(t, nj)).cumsum(axis=0) * 1e-3
    qd = np.gradient(q, axis=0)
    tau = torch.as_tensor(rng.normal(size=(t, nj)))
    base = np.stack([np.linspace(0, 0.5, t), np.zeros(t),
                     0.25 + 0.01 * np.sin(np.linspace(0, 6, t))], axis=1)
    fig = plots.plot_whole_body_solution(torch.as_tensor(q), qd, tau, 0.001,
                                         base_pos=torch.as_tensor(base),
                                         save_dir=tmp_path)
    assert fig is not None
    assert (tmp_path / "whole_body_solution.png").exists()
    assert (tmp_path / "whole_body_base_path.png").exists()


def test_existing_figures_still_render(tmp_path):
    U = np.abs(np.random.default_rng(2).normal(size=(40, 12)))
    plots.plot_contact_forces(["FR", "FL", "HR", "HL"], torch.as_tensor(U),
                              None, 0.01, 0.5, save_dir=tmp_path)
    plots.plot_tracking_cost(
        {"nominal_cum_cost": np.linspace(0, 1, 50),
         "nominal_cum_cost_std": np.full(50, 0.1)}, 0.01,
        save_dir=tmp_path)
    X = torch.zeros(41, 9)
    plots.plot_centroidal_trajectory(X, X + 0.01, 0.01, save_dir=tmp_path)
    for name in ("force_ratios", "tracking_cost", "centroidal_trajectory"):
        assert (tmp_path / f"{name}.png").exists()


def _synthetic_motion():
    T, L = 40, 4
    t = np.linspace(0, 1, T)
    base = np.stack([t * 0.3, np.zeros(T), 0.25 + 0.01 * np.sin(6 * t)], 1)
    feet = np.zeros((T, L, 3))
    feet[:, :, 0] = base[:, None, 0] + np.array([0.19, 0.19, -0.19, -0.19])
    feet[:, :, 1] = np.array([-0.15, 0.15, -0.15, 0.15])
    stance = (np.sin(12 * t)[:, None] > 0).astype(float).repeat(L, 1)
    q = np.random.default_rng(3).uniform(-0.8, 0.8, (T, L, 3))
    return base, feet, stance, q


def test_motion_preview_html_standalone():
    base, feet, stance, _ = _synthetic_motion()
    html = motion_preview_html(base, feet, stance, dt=0.01,
                               foot_names=["FR", "FL", "HR", "HL"],
                               stones=[{"c": [0.2, 0.0, 0.02],
                                        "size": [0.1, 0.1],
                                        "R": np.eye(3)}])
    # self-contained: no external fetches of any kind
    assert "http://" not in html and "https://" not in html
    assert "<script src" not in html
    data = _extract_data(html)
    assert len(data["base"]) == 40 and len(data["feet"][0]) == 4
    assert data["footNames"] == ["FR", "FL", "HR", "HL"]
    assert len(data["stones"]) == 1 and len(data["stones"][0]["R"]) == 9


@pytest.mark.parametrize("legs", ["default", "knees"])
def test_motion_preview_html_is_the_jax_packages(legs):
    """Byte for byte the JAX package's HTML on the same numpy inputs,
    with the generic hip rectangle or with knees from joint angles and the
    trot debris stones."""
    base, feet, stance, q = _synthetic_motion()
    kw = dict(foot_names=("FR", "FL", "HR", "HL"), title="trot")
    if legs == "knees":
        g = kin.SOLO12_LEGS
        kw.update(q=q, hips_body=g.hip_positions(), sides=g.side_signs(),
                  l_upper=g.l_upper, y_off=g.y_off, com_path=base + 0.01,
                  stones=[{"c": [s.center[0], s.center[1], s.height],
                           "size": list(s.size), "R": s.rotation()}
                          for s in ter.TROT_DEBRIS.stones])
    got = motion_preview_html(base, feet, stance, 0.01, **kw)
    assert got == jpreview.motion_preview_html(base, feet, stance, 0.01,
                                               **kw)


def test_knee_fk_matches_leg_fk():
    """With kfe = 0 the straight leg's foot is collinear with hip -> knee
    at l_upper / l_total (the port's leg_fk)."""
    g = kin.SOLO12_LEGS
    rng = np.random.default_rng(0)
    q = rng.uniform(-0.8, 0.8, (5, 4, 3))
    q[..., 2] = 0.0
    sides = np.asarray(g.side_signs())
    knees = _knee_positions(q, sides, g.l_upper, g.y_off)
    feet = kin.leg_fk(torch.as_tensor(q), torch.as_tensor(sides), g).numpy()
    frac = g.l_upper / (g.l_upper + g.l_lower)
    lateral = np.stack([np.zeros((5, 4)), sides * g.y_off * np.cos(q[..., 0]),
                        sides * g.y_off * np.sin(q[..., 0])], -1)
    np.testing.assert_allclose(knees, lateral + frac * (feet - lateral),
                               atol=1e-9)


def _fake_result(x, pos, logic, wb=None, stones=None):
    plan = types.SimpleNamespace(schedule=types.SimpleNamespace(
        position=pos, logic=logic))
    return types.SimpleNamespace(
        nominal=types.SimpleNamespace(X=x), problem=types.SimpleNamespace(
            plan=plan), wb_traj=wb,
        terrain=None if stones is None else ter.Terrain(stones=stones))


def test_write_motion_preview_fallback(tmp_path):
    """The PipelineResult-facing writer on the planning-knot fallback
    path; the port's solutions carry the B = 1 axis."""
    res = _fake_result(torch.zeros(1, 21, 9), torch.zeros(20, 4, 3),
                       torch.ones(20, 4))
    preset = types.SimpleNamespace(
        name="synthetic", dt=0.01, dt_ctrl=0.001,
        robot=types.SimpleNamespace(n_contacts=4,
                                    foot_names=("FR", "FL", "HR", "HL")))
    path = write_motion_preview(res, preset, str(tmp_path))
    data = _extract_data(open(path).read())
    assert len(data["base"]) == 20
    assert data["title"].startswith("synthetic")


def test_write_motion_preview_is_the_jax_packages(tmp_path):
    """The whole-body branch on the same data in both packages (the
    port's tensors, the JAX package's numpy arrays), with terrain stones:
    the same file."""
    rng = np.random.default_rng(4)
    T = 60
    wb = {"base_pos": rng.normal(size=(T, 3)), "q": rng.normal(size=(T, 12)),
          "feet": rng.normal(size=(T, 4, 3))}
    x = rng.normal(size=(7, 9))
    pos, logic = rng.normal(size=(6, 4, 3)), np.ones((6, 4))
    preset = jpresets.SOLO12_TROT
    tres = _fake_result(torch.as_tensor(x)[None], torch.as_tensor(pos),
                        torch.as_tensor(logic), types.SimpleNamespace(
                            **{k: torch.as_tensor(v) for k, v in wb.items()}),
                        ter.TROT_DEBRIS.stones)
    from centroidal_mpc_tpu.contact import terrain as jter
    jres = _fake_result(x, pos, logic, types.SimpleNamespace(**wb),
                        jter.TROT_DEBRIS.stones)
    got = write_motion_preview(tres, presets.SOLO12_TROT, str(tmp_path / "t"))
    want = jpreview.write_motion_preview(jres, preset, str(tmp_path / "j"))
    assert open(got).read() == open(want).read()


@pytest.mark.parametrize("name", ["solo12_trot_mini", "bolt_pace"])
def test_interpolate_contact_positions_matches_jax(name):
    jprob = jpresets.build_problem(jpresets.PRESETS[name],
                                   dtype=jnp.float64)
    prob = presets.build_problem(presets.PRESETS[name], dtype=torch.float64,
                                 device="cpu")
    want = jinterp(jprob.plan, 0.001)
    got = interpolate_contact_positions(prob.plan, 0.001)
    assert got.shape == want.shape and got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)
