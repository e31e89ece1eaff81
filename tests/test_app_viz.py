"""Headless Application loop, offline renderer, and the scene-runner CLI."""

import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "samples", "scenes", "cloth.xml")


def _ctx():
    from admm_elastic_tpu.models import StaticAnchor
    from admm_elastic_tpu.scene import SimContext

    ctx = SimContext()
    ctx.load(SCENE)
    ctx.system.settings.admm_iters = 5
    ctx.system.add_force(StaticAnchor([0, 20]))
    ctx.initialize()
    return ctx


def test_application_loop_controls(tmp_path):
    from admm_elastic_tpu.app import Application

    ctx = _ctx()
    app = Application(ctx, screen_dt=0.04)
    app.frame_dir = str(tmp_path)
    app.fire("toggle_run")  # pause
    app.display(2)
    assert ctx.system.elapsed_s == 0.0
    app.fire("toggle_run")
    events = []
    app.on("gust", lambda a: events.append(a.frame))
    app.fire("gust")
    app.fire("toggle_save")
    app.display(2)
    assert ctx.system.elapsed_s > 0.0
    assert events == [2]
    assert any(f.endswith(".obj") for f in os.listdir(tmp_path))


def test_render_frame(tmp_path):
    from admm_elastic_tpu.viz import render_frame

    ctx = _ctx()
    ctx.step()
    ctx.update()
    out = render_frame(ctx.objects, str(tmp_path / "f.png"))
    assert os.path.getsize(out) > 10_000  # non-trivial image


def test_cli_scene_runner(tmp_path):
    env = dict(os.environ)
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    ck = str(tmp_path / "ck.npz")
    r = subprocess.run(
        [sys.executable, "-m", "admm_elastic_tpu", SCENE, "--steps", "3",
         "--checkpoint", ck, "-it", "5"],
        capture_output=True, text=True, env=env, timeout=240,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "done: 3 steps" in r.stdout
    assert os.path.exists(ck)
    data = np.load(ck)
    assert "x" in data.files and data["x"].shape[1] == 3


def test_render_scene_consumes_materials_and_lights(tmp_path):
    """The offline renderer consumes the XML-declared BlinnPhong materials
    and point lights (Material.hpp / Light.hpp / RenderGL semantics):
    rendering with the scene's gray vs white materials produces visibly
    different pixels for the pole object."""
    import os

    from admm_elastic_tpu.scene import SimContext
    from admm_elastic_tpu.viz import render_scene

    scene = os.path.join(
        os.path.dirname(__file__), "..", "samples", "scenes", "cloth.xml"
    )
    ctx = SimContext()
    ctx.load(scene)
    ctx.initialize()
    assert ctx.scene.materials, "cloth.xml declares materials"
    # programmatic lights (SceneManager::make_light analog) feed the render
    ctx.make_light("point", name="p1", position=(10, 10, 10),
                   intensity=(0.7, 0.7, 0.7), falloff=(1, 0, 0))
    ctx.make_light("point", name="p2", position=(-10, 10, -10),
                   intensity=(0.5, 0.5, 0.5), falloff=(1, 0, 0))
    assert ctx.scene.lights
    p1 = render_scene(ctx, str(tmp_path / "lit.png"))
    assert os.path.exists(p1)

    # flat fallback (no lights) must differ from the lit render
    from admm_elastic_tpu.viz import render_frame

    p2 = render_frame(ctx.objects, str(tmp_path / "flat.png"))
    import matplotlib.image as mpimg

    a, b = mpimg.imread(p1), mpimg.imread(p2)
    assert a.shape == b.shape
    assert np.abs(a.astype(float) - b.astype(float)).max() > 0.05


def test_html_viewer_export(tmp_path):
    """The interactive HTML viewer (viewer.py — the Application.cpp
    orbit/play analog) embeds a decodable payload: the uint16-quantized
    per-frame positions round-trip to the recorded vertices within
    quantization error, and the per-object offsets/faces are exact."""
    import base64
    import json
    import re

    import numpy as np

    from admm_elastic_tpu.geometry import make_sym_plane
    from admm_elastic_tpu.viewer import export_html_viewer

    m = make_sym_plane(4, 3)
    rng = np.random.RandomState(0)
    frames = []
    for t in range(5):
        v = m.vertices + 0.1 * np.sin(t + m.vertices[:, :1])
        frames.append([v, m.vertices + (1.0, 0, 0)])
    faces = [m.faces, m.faces]
    p = str(tmp_path / "viewer.html")
    export_html_viewer(frames, faces, p, names=["a", "b"], fps=24)
    html = open(p).read()
    meta = json.loads(re.search(r"const META = (.*?);\n", html).group(1))
    payload = re.search(r'const PAYLOAD = "(.*?)";', html).group(1)
    u16 = np.frombuffer(base64.b64decode(payload), np.uint16)
    lo = np.asarray(meta["bbox_min"])
    scale = np.asarray(meta["bbox_scale"])
    stride = sum(o["nv"] * 3 for o in meta["objects"])
    assert meta["n_frames"] == 5 and len(meta["objects"]) == 2
    assert u16.size == 5 * stride
    tol = scale.max() + 1e-12
    for fi in (0, 4):
        for oi, o in enumerate(meta["objects"]):
            start = fi * stride + o["offset"]
            q = u16[start:start + o["nv"] * 3].reshape(-1, 3)
            dec = lo + scale * q
            np.testing.assert_allclose(dec, frames[fi][oi], atol=tol)
            assert o["faces"] == list(np.asarray(faces[oi]).reshape(-1))
    # the embedded script carries the interaction surface
    for token in ("webgl2", "ArrowRight", "onwheel", "requestAnimationFrame"):
        assert token in html, token


def test_cli_sharded_runner(tmp_path):
    """`--sharded N`: the scene runs element-sharded (halo path) from
    the CLI on a virtual device mesh, with checkpointing through
    detach()."""
    env = dict(os.environ)
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ck = str(tmp_path / "ck.npz")
    r = subprocess.run(
        [sys.executable, "-m", "admm_elastic_tpu", SCENE, "--steps", "3",
         "--sharded", "4", "--checkpoint", ck, "-it", "5"],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "done (sharded x4): 3 steps" in r.stdout
    assert "finite=True" in r.stdout
    data = np.load(ck)
    assert "x" in data.files and data["x"].shape[1] == 3
