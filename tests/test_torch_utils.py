"""The port's utils on the CPU: the cases of tests/test_utils.py (less the
matmul DFT, which the port does not carry) on the port's models, the
torch.profiler trace, and checkpoints that cross between the packages: a
JAX ``save_model`` restored into the port's model and a port save restored
into JAX's, both then stepping 4 times to the same state within 5e-7
(tests/test_fused.py's bar), for a single-tensor state (``PipeFlow``) and a
tuple state (``RepellingFisherWave``).
"""

import base64
import io
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

import lb2d_tpu.models as jax_models
import lb2d_tpu.utils.checkpoint as jax_checkpoint
import lb2d_tpu_torch.models as torch_models
from lb2d_tpu_torch.utils import (
    FieldAnimator,
    MachWatchdog,
    MLUPSMeter,
    accumulated_sum,
    colormap_lut,
    conservation_report,
    load_state,
    mach_number,
    render_field,
    restore_model,
    save_model,
    save_state,
    time_steps,
    trace,
)
from lb2d_tpu_torch.utils.render import LiveView

torch.set_num_threads(1)

TOL = 5e-7
PARAMS = dict(diameter=1.5, rho=10.0, viscosity=5.0, pressure_grad=-100.0,
              pipe_length=3.0, N=10)
WAVE = dict(Lx=1.0, Ly=1.0, E=2.0, R0=0.25, N=24, max_inner_iter=60,
            inner_tolerance=1e-4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pipe():
    return torch_models.PipeFlow(device="cpu", **PARAMS)


def _wave():
    return torch_models.RepellingFisherWave(device="cpu", **WAVE)


def test_mach_watchdog():
    u = torch.full((4, 4), 0.01)
    v = torch.zeros((4, 4))
    assert mach_number(u, v) == pytest.approx(0.01 * np.sqrt(3), rel=1e-5)
    with pytest.warns(UserWarning, match="Mach"):
        MachWatchdog(tolerance=0.1).check(torch.full((4, 4), 0.2), v)


def test_conservation_report():
    sim = _pipe()
    rep0 = conservation_report(sim.state)
    sim.run(50)
    rep1 = conservation_report(sim.state)
    assert np.isfinite(rep1["sum_f"])
    assert abs(rep1["sum_f"] - rep0["sum_f"]) < 0.05 * abs(rep0["sum_f"])


def test_checkpoint_roundtrip_plain_state(tmp_path):
    sim = _pipe()
    sim.run(20)
    path = str(tmp_path / "ckpt.npz")
    save_model(path, sim)
    before = sim.state.clone()
    sim.run(10)
    restore_model(path, sim)
    assert torch.equal(sim.state, before)
    assert sim.state.device == sim.device
    sim.run(10)
    sim2 = _pipe()
    sim2.run(30)
    np.testing.assert_allclose(sim.state.numpy(), sim2.state.numpy(),
                               rtol=1e-6, atol=1e-7)


def test_checkpoint_of_a_sharded_model_is_the_global_state(tmp_path):
    """A sharded model saves its gathered global state (one leaf, as the
    unsharded model's file) and restores it into its shards."""
    from lb2d_tpu_torch.parallel import ShardedPipeFlow, make_mesh

    kw = dict(PARAMS, N=15, pipe_length=1.5 * 30.5 / 15)  # 16 x 32
    sh = ShardedPipeFlow(mesh=make_mesh(devices=["cpu"] * 4, shape=(2, 2)),
                         **kw)
    sh.run(5)
    path = str(tmp_path / "ckpt.npz")
    save_model(path, sh)
    saved = sh.state_numpy()
    np.testing.assert_array_equal(load_state(path), saved)
    sh.run(3)
    restore_model(path, sh)
    np.testing.assert_array_equal(sh.state_numpy(), saved)
    single = restore_model(path, torch_models.PipeFlow(device="cpu", **kw))
    np.testing.assert_array_equal(single.state_numpy(), saved)


def test_checkpoint_tuple_state(tmp_path):
    sim = _wave()
    sim.run(3)
    path = str(tmp_path / "ckpt.npz")
    save_state(path, sim.state)
    restored = load_state(path, like=sim.state)
    assert isinstance(restored, tuple) and len(restored) == 5
    for a, b in zip(restored, sim.state):
        np.testing.assert_array_equal(a, b.numpy())


def test_render_field():
    lut = colormap_lut("magma")
    assert lut.shape == (256, 3) and lut.dtype == np.uint8
    field = np.linspace(0, 1, 64 * 32).reshape(64, 32)
    img = np.asarray(render_field(field))
    assert img.shape == (64, 32, 3) and img.dtype == np.uint8
    np.testing.assert_array_equal(img[0, 0], lut[0])
    np.testing.assert_array_equal(img[-1, -1], lut[255])
    img2 = np.asarray(render_field(field, clim=(0.25, 0.75)))
    np.testing.assert_array_equal(img2[0, 0], lut[0])
    np.testing.assert_array_equal(img2[-1, -1], lut[255])
    # a field tensor renders on its own device, as a tensor
    out = render_field(torch.tensor(field), lut=lut)
    assert isinstance(out, torch.Tensor) and out.device == torch.device("cpu")
    np.testing.assert_array_equal(out.numpy(), img)


def test_render_field_without_matplotlib():
    """Without matplotlib the package imports and render_field runs with
    an explicit lut."""
    code = ("import sys; sys.modules['matplotlib'] = None\n"
            "import numpy as np, lb2d_tpu_torch.utils as u\n"
            "lut = np.arange(768, dtype=np.uint8).reshape(256, 3)\n"
            "img = u.render_field(np.eye(4), lut=lut)\n"
            "assert img.shape == (4, 4, 3)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_field_animator():
    sim = _pipe()
    anim = FieldAnimator(sim, field="u", steps_per_frame=5)
    frame = anim.frame()
    assert frame.shape[-1] == 3 and frame.dtype == np.uint8
    assert sim.steps_taken == 5


def test_time_steps_profiling():
    res = time_steps(_pipe(), num_steps=10, repeats=2)
    assert len(res) == 2 and all(r["mlups"] > 0 for r in res)


def test_trace_writes_a_chrome_trace(tmp_path):
    sim = _pipe()
    with trace(str(tmp_path / "tr")) as logdir:
        sim.run(3)
    with open(os.path.join(logdir, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("roll" in str(e.get("name", "")) for e in events)


def test_mlups_meter():
    sim = _pipe()
    step = sim._step

    def run_fn(f, n):
        for _ in range(n):
            f = step(f)
        return f

    state, mlups = MLUPSMeter(sim.num_cells).measure(run_fn, sim.state, 5)
    assert mlups > 0 and state.shape == sim.state.shape


def test_run_zero_steps_is_noop():
    sim = torch_models.PipeFlow(N=31, pipe_length=1.0, diameter=1.0, rho=1.0,
                                viscosity=1.0, pressure_grad=-10.0,
                                device="cpu")
    before = sim.state.clone()
    sim.run(0)
    assert torch.equal(before, sim.state)
    sim.run(0, timed=True)
    assert sim.steps_taken == 0


def test_run_below_steps_per_call_uses_remainder_path():
    """A model whose step advances 4 steps, asked for 3, runs 3 single
    steps and equals a plain twin exactly."""
    sim = torch_models.Diffusion(Lx=0.21, Ly=0.21, z=0.1, N=63, device="cpu")
    one = sim._step

    def sweep(f):
        raise AssertionError("the 4-step sweep must not run for 3 steps")

    sim.steps_per_call, sim._single_step, sim._step = 4, one, sweep
    twin = torch_models.Diffusion(Lx=0.21, Ly=0.21, z=0.1, N=63, device="cpu")
    sim.run(3)
    twin.run(3)
    assert torch.equal(sim.state, twin.state)


def test_field_animator_multifield():
    """Without a device field the animator renders get_fields()'s reference
    layout [nx, ny, F] (field 0)."""
    sim = torch_models.FisherExpansion(
        Lx=4.0, Ly=4.0, mu_standard=1.0, mu_list=[1.0], D_standard=1.0,
        D_list=[1.0], N=10, initial_frac_widths=[1.0],
        initial_frac_indices=[0], device="cpu")
    sim.device_field = lambda name: None
    frame = FieldAnimator(sim, field="rho", steps_per_frame=5).frame()
    assert frame.dtype == np.uint8 and frame.shape == (sim.ny, sim.nx, 3)
    assert sim.steps_taken == 5


def test_checkpoint_self_describing_no_template(tmp_path):
    state = (np.arange(6, dtype=np.float32).reshape(2, 3),
             {"key": np.asarray([1, 2], np.int32),
              "aux": (np.float32(3.5), None)})
    path = str(tmp_path / "ckpt.npz")
    save_state(path, state)
    out = load_state(path)
    assert isinstance(out, tuple) and isinstance(out[1], dict)
    np.testing.assert_array_equal(out[0], state[0])
    np.testing.assert_array_equal(out[1]["key"], state[1]["key"])
    assert float(out[1]["aux"][0]) == 3.5
    assert out[1]["aux"][1] is None


def test_checkpoint_model_roundtrip_no_template(tmp_path):
    sim = _wave()
    sim.run(2)
    path = str(tmp_path / "ckpt.npz")
    save_state(path, sim.state)
    out = load_state(path)
    assert isinstance(out, tuple) and len(out) == len(sim.state)
    np.testing.assert_array_equal(out[0], sim.state[0].numpy())


def test_legacy_checkpoint_without_structure(tmp_path):
    """A file without ``__structure__`` loads as a flat leaf list, or fills
    ``like`` in JAX's leaf order (dict keys sorted)."""
    path = str(tmp_path / "legacy.npz")
    np.savez(path, leaf_0=np.ones(2, np.float64), leaf_1=np.zeros(3),
             __num_leaves__=np.asarray(2))
    flat = load_state(path)
    assert isinstance(flat, list) and len(flat) == 2
    like = {"b": torch.zeros(3), "a": torch.zeros(2, dtype=torch.float32)}
    out = load_state(path, like=like)
    assert out["a"].dtype == np.float32 and out["a"].shape == (2,)
    assert out["b"].shape == (3,)
    with pytest.raises(ValueError):
        load_state(path, like=(torch.zeros(2),))


def test_live_view_terminal_and_html(tmp_path):
    lv = LiveView(_pipe(), steps_per_frame=2)
    buf = io.StringIO()
    lv.to_terminal(num_frames=2, max_cols=32, out=buf)
    out = buf.getvalue()
    assert "▀" in out and "frame 2/2" in out
    path = lv.to_html(str(tmp_path / "live.html"), num_frames=2, fps=5)
    html = open(path).read()
    assert html.startswith("<!doctype html>")
    m = re.search(r"F=\['([A-Za-z0-9+/=]+)'", html)
    assert base64.b64decode(m.group(1))[:8] == b"\x89PNG\r\n\x1a\n"


def test_accumulated_sum_f64_mode():
    rs = np.random.RandomState(3)
    x = (0.5 + rs.rand(512, 512)).astype(np.float32)
    truth = float(np.sum(x.astype(np.float64)))
    xt = torch.tensor(x)
    assert abs(accumulated_sum(xt, "f64") - truth) / abs(truth) < 3e-9
    assert abs(accumulated_sum(xt, "f32") - truth) / abs(truth) < 1e-4
    rep = conservation_report(torch.stack([xt] * 3), rho=xt,
                              accumulate="f64")
    assert abs(rep["sum_rho"] - truth) / abs(truth) < 3e-9
    assert abs(rep["sum_f"] - 3 * truth) / abs(truth) < 3e-9


# model -> (JAX model, port model), built from the same arguments
CROSS = {
    "PipeFlow": (lambda: jax_models.PipeFlow(**PARAMS), _pipe),
    "RepellingFisherWave": (lambda: jax_models.RepellingFisherWave(**WAVE),
                            _wave),
}


def _states_agree(jax_sim, torch_sim):
    jax_state = jax_sim.state
    port_state = torch_sim.state_numpy()
    if not isinstance(port_state, tuple):
        jax_state, port_state = (jax_state,), (port_state,)
    assert len(jax_state) == len(port_state)
    for i, (a, b) in enumerate(zip(jax_state, port_state)):
        d = float(np.abs(np.asarray(a) - b).max())
        assert d < TOL, (i, d)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("model", list(CROSS))
def test_checkpoint_crosses_packages(model, writer):
    make_jax, make_port = CROSS[model]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ckpt.npz")
        if writer == "jax":
            src = make_jax()
            src.run(3)
            jax_checkpoint.save_model(path, src)
            jax_sim, port_sim = src, restore_model(path, make_port())
        else:
            src = make_port()
            src.run(3)
            save_model(path, src)
            jax_sim = jax_checkpoint.restore_model(path, make_jax())
            port_sim = src
        _states_agree(jax_sim, port_sim)
    jax_sim.run(4)
    port_sim.run(4)
    _states_agree(jax_sim, port_sim)
