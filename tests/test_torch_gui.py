"""PyTorch port, network GUI (`utils/network_gui.py`) over loopback: the same packets
give the same cameras, flags and frame bytes as the JAX package's `NetworkGUI` (frames
with values at the uint8 truncation edges and outside [0, 1]); the round trip of the JAX
package's test (tests/test_aux.py); a message that arrives in pieces read whole (the JAX
`_read` calls recv once per part); an error raised by the render reaching the caller
(the JAX `poll` swallows every Exception); a bad message dropping the viewer; and a
`training()` run serving frames at iteration 1 byte-equal to a render of the field
that scene creation gives."""

import json
import socket
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langsplat_tpu.utils.network_gui import NetworkGUI as JaxNetworkGUI
from langsplat_tpu_torch.utils import network_gui
from langsplat_tpu_torch.utils.network_gui import NetworkGUI, ViewerClient

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)


def packet(w=8, h=6, train=True, keep_alive=True, view=None, proj=None, fov_x=0.9,
           fov_y=0.8, scaling_modifier=1.0) -> bytes:
    view = np.eye(4) if view is None else view
    proj = view if proj is None else proj
    return network_gui.viewer_packet(w, h, fov_x, fov_y, view, proj, train=train,
                                     keep_alive=keep_alive,
                                     scaling_modifier=scaling_modifier)


def served_gui():
    gui = NetworkGUI()
    gui.init("127.0.0.1", 0)
    return gui, gui.listener.getsockname()[1]


def accept(gui):
    """Works for both packages' servers (the JAX `try_connect` takes no timeout)."""
    for _ in range(200):
        gui.try_connect()
        if gui.conn is not None:
            return
        time.sleep(0.02)
    raise AssertionError("no client connected")


def edge_image(h, w) -> np.ndarray:
    """[3,h,w] float32 at the uint8 truncation edges: k/255, one float32 step either
    side of it, the midpoints, and values outside [0, 1]."""
    k = np.arange(256, dtype=np.float32)
    exact = k / np.float32(255)
    values = np.concatenate([
        exact, np.nextafter(exact, np.float32(-1)), np.nextafter(exact, np.float32(2)),
        (k + np.float32(0.5)) / np.float32(255),
        np.float32([0, 1, -0.25, -1e-8, 1 + 1e-7, 1.5, 255, -255])])
    return np.resize(values.astype(np.float32), (3, h, w))


# name -> (width, height, train, keep_alive, scaling_modifier)
WIRE = {"held": (24, 16, False, True, 0.5), "released": (24, 16, True, False, 1.0),
        "no_frame": (0, 0, False, True, 1.0)}


@pytest.mark.parametrize("name", sorted(WIRE))
def test_the_wire_format_matches_jax(name):
    """The same messages, each arriving whole (the JAX `_read` only handles those), to
    the JAX server and the port's: `receive` gives the same camera fields, matrices and
    flags, and `poll` with one image as the render sends the same bytes."""
    w, h, train, keep_alive, scale = WIRE[name]
    rng = np.random.default_rng(11)
    view, proj = rng.normal(size=(4, 4)), rng.normal(size=(4, 4))
    msg = packet(w, h, train=train, keep_alive=keep_alive, view=view, proj=proj,
                 fov_x=0.83, fov_y=0.61, scaling_modifier=scale)
    release = packet(24, 16, train=True, keep_alive=False, view=view, proj=proj)
    image = edge_image(16, 24)
    served = {}
    for pkg, gui, as_array in (("jax", JaxNetworkGUI(), jnp.asarray),
                               ("port", NetworkGUI(), torch.tensor)):
        gui.init("127.0.0.1", 0)
        with ViewerClient("127.0.0.1", gui.listener.getsockname()[1], 10) as viewer:
            viewer.sock.sendall(msg + msg + release)
            accept(gui)
            received = gui.receive()
            asked = []

            def render_fn(cam, scale_mod):
                asked.append((cam, scale_mod))
                return as_array(image)

            gui.poll(render_fn, "source-path", 1, 10)
            # a released loop is served one frame; a held one the release's too
            replies = [viewer.reply(w, h)] + ([] if train else [viewer.reply(24, 16)])
        gui.disconnect()
        gui.listener.close()
        served[pkg] = (received, asked, replies)

    (jrecv, jasked, jreplies), (trecv, tasked, treplies) = served["jax"], served["port"]
    assert len(jrecv) == len(trecv) == 6
    assert jrecv[1:] == trecv[1:]                          # flags and scaling modifier
    assert type(trecv[5]) is type(jrecv[5])
    if w == 0:
        assert jrecv[0] is None and trecv[0] is None
    else:
        jcam, tcam = jrecv[0], trecv[0]
        for field in ("width", "height", "fovy", "fovx", "znear", "zfar"):
            assert getattr(tcam, field) == getattr(jcam, field), field
        for field in ("world_view_transform", "full_proj_transform"):
            a, b = getattr(tcam, field), getattr(jcam, field)
            assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert [sc for _, sc in tasked] == [sc for _, sc in jasked]
    assert len(tasked) == (1 if w == 0 or train else 2)
    assert treplies == jreplies                            # frame bytes, verify strings
    assert treplies[-1][1] == "source-path" and len(set(treplies[-1][0])) > 200


def run_client(target):
    results = {}
    t = threading.Thread(target=lambda: results.update(target()), daemon=True)
    t.start()
    return t, results


def test_network_gui_roundtrip():
    gui, port = served_gui()

    def client():
        with ViewerClient("127.0.0.1", port, 10) as viewer:
            image, verify = viewer.request(packet(), 8, 6)
        return {"image": image, "verify": verify}

    t, results = run_client(client)
    accept(gui)
    cam, do_training, _, _, keep_alive, scale = gui.receive()
    assert cam.width == 8 and cam.height == 6
    assert do_training and keep_alive and scale == 1.0
    # Y/Z columns sign-flipped
    np.testing.assert_array_equal(cam.world_view_transform[:, 1], [0, -1, 0, 0])
    np.testing.assert_array_equal(cam.world_view_transform[:, 2], [0, 0, -1, 0])
    np.testing.assert_array_equal(cam.full_proj_transform[:, 1], [0, -1, 0, 0])
    np.testing.assert_array_equal(cam.full_proj_transform[:, 2], [0, 0, 1, 0])
    image = torch.full((3, 6, 8), 0.5)
    gui.send(network_gui.frame_bytes(image), "verify-string")
    t.join(timeout=10)
    assert not t.is_alive()
    assert results["verify"] == "verify-string"
    want = (np.clip(image.numpy(), 0, 1) * 255).astype(np.uint8).transpose(1, 2, 0)
    assert results["image"] == np.ascontiguousarray(want).tobytes()
    gui.close()


def test_a_message_in_pieces_is_read_whole():
    """Fault (a) of the JAX package: its `_read` takes what one recv returns."""
    gui, port = served_gui()
    data = packet(w=5, h=3)

    def client():
        with ViewerClient("127.0.0.1", port, 10) as viewer:
            for lo, hi in ((0, 2), (2, 9), (9, 40), (40, len(data))):
                viewer.sock.sendall(data[lo:hi])
                time.sleep(0.1)
            viewer.reply(5, 3)
        return {}

    t, _ = run_client(client)
    accept(gui)
    cam, *_ = gui.receive()
    assert (cam.width, cam.height) == (5, 3)
    gui.send(bytes(5 * 3 * 3), "v")
    t.join(timeout=10)
    assert not t.is_alive()
    gui.close()


@pytest.mark.parametrize("error", [RuntimeError, ValueError])
def test_a_render_error_reaches_the_caller(error):
    """Fault (b) of the JAX package: its `poll` catches every Exception, so a failed
    render (a kernel launch error, a tensor on the wrong device) drops the viewer in
    silence. The port lets it propagate, ValueError included."""
    gui, port = served_gui()

    def client():
        with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
            s.sendall(packet(train=False))
            s.settimeout(10)
            return {"tail": s.recv(1)}

    t, _ = run_client(client)
    accept(gui)

    def failing(cam, scale):
        raise error("blend_fwd kernel launch failed")

    with pytest.raises(error, match="launch failed"):
        gui.poll(failing, "src", 1, 10)
    gui.close()
    t.join(timeout=10)
    assert not t.is_alive()


@pytest.mark.parametrize("payload", [b"{not json", json.dumps({"train": True}).encode()])
def test_a_bad_message_drops_the_viewer(payload):
    gui, port = served_gui()

    def client():
        with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
            s.sendall(len(payload).to_bytes(4, "little") + payload)
            s.settimeout(10)
            return {"tail": s.recv(1)}       # b"": the server closed the connection

    t, results = run_client(client)
    accept(gui)
    gui.poll(lambda cam, scale: torch.zeros(3, cam.height, cam.width), "src", 1, 10)
    assert gui.conn is None
    t.join(timeout=10)
    assert not t.is_alive() and results["tail"] == b""
    gui.close()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_training_serves_the_created_field(tmp_path):
    """`training()` with the GUI on the CPU: the viewer holds iteration 1 for two frames
    (train off), then releases it; both frames equal the uint8 render of the field
    that scene creation gives for the seed, through the viewer's camera."""
    from langsplat_tpu_torch.config import ModelConfig, OptimizationConfig, TrainConfig
    from langsplat_tpu_torch.data.scene import Scene
    from langsplat_tpu_torch.ops.render import RenderSettings, render
    from langsplat_tpu_torch.train.loop import training

    from tests.test_data import make_colmap_scene

    scene_dir = str(tmp_path / "scene")
    make_colmap_scene(scene_dir, n_cams=2)
    mcfg = ModelConfig(source_path=scene_dir, resolution=1, sh_degree=1)
    cfg = TrainConfig(model=mcfg, optimization=OptimizationConfig(
        iterations=2, include_feature=False), test_iterations=(), save_iterations=(),
        checkpoint_iterations=(), quiet=True)
    cam = Scene(mcfg, device="cpu", shuffle=False).get_train_cameras()[0]
    created = Scene(mcfg, device="cpu", seed=cfg.seed,
                    initial_capacity_factor=cfg.optimization.initial_capacity_factor)
    width, height = cam.width, cam.height
    flip = np.diag([1.0, -1.0, -1.0, 1.0])
    view = cam.world_view_transform @ flip          # as the viewer sends it
    proj = cam.full_proj_transform @ np.diag([1.0, -1.0, 1.0, 1.0])
    settings = RenderSettings(image_height=height, image_width=width,
                              tanfovx=cam.tanfovx, tanfovy=cam.tanfovy,
                              sh_degree=0, include_feature=False,
                              budget=6 * created.gaussians.capacity)
    with torch.no_grad():
        mats = [torch.tensor(np.asarray(m, np.float32)) for m in (
            cam.world_view_transform, cam.full_proj_transform,
            np.linalg.inv(cam.world_view_transform)[3, :3])]
        want = bytes(network_gui.frame_bytes(render(created.gaussians, settings, *mats,
                                                    torch.zeros(3))["render"]))

    port = free_port()

    def client():
        frames = []
        with ViewerClient("127.0.0.1", port, timeout=30) as viewer:
            for train in (False, False, True):
                frames.append(viewer.request(
                    packet(width, height, train=train, keep_alive=False, view=view,
                           proj=proj, fov_x=cam.fov_x, fov_y=cam.fov_y), width, height))
        return {"frames": frames}

    t, results = run_client(client)
    # the first step waits for the viewer, so iteration 1 is the one it sees
    result = training(cfg, device="cpu", gui_port=port, gui_wait=30)
    t.join(timeout=30)
    assert not t.is_alive()
    assert len(result["history"]) == 2
    frames = results["frames"]
    assert [v for _, v in frames] == [scene_dir] * 3
    assert frames[0][0] == want and frames[1][0] == want
    assert len(set(want)) > 10                     # something was drawn


def test_a_port_in_use_disables_the_gui(tmp_path, capsys):
    from langsplat_tpu_torch.config import ModelConfig, OptimizationConfig, TrainConfig
    from langsplat_tpu_torch.train.loop import training

    from tests.test_data import make_colmap_scene

    scene_dir = str(tmp_path / "scene")
    make_colmap_scene(scene_dir, n_cams=2)
    cfg = TrainConfig(
        model=ModelConfig(source_path=scene_dir, resolution=1, sh_degree=1),
        optimization=OptimizationConfig(iterations=1, include_feature=False),
        test_iterations=(), save_iterations=(), checkpoint_iterations=())
    with socket.socket() as taken:
        taken.bind(("127.0.0.1", 0))
        taken.listen()
        result = training(cfg, device="cpu", gui_port=taken.getsockname()[1])
    assert len(result["history"]) == 1
    assert "network GUI disabled" in capsys.readouterr().out


def test_a_failed_step_releases_the_trace_and_the_port(tmp_path, monkeypatch):
    """A step that raises inside the trace window, with the GUI bound: the error reaches
    the caller, the profiler is stopped and the port is free again."""
    from langsplat_tpu_torch.config import ModelConfig, OptimizationConfig, TrainConfig
    from langsplat_tpu_torch.train import loop

    from tests.test_data import make_colmap_scene

    scene_dir = str(tmp_path / "scene")
    make_colmap_scene(scene_dir, n_cams=2)
    cfg = TrainConfig(
        model=ModelConfig(source_path=scene_dir, resolution=1, sh_degree=1),
        optimization=OptimizationConfig(iterations=4, include_feature=False),
        test_iterations=(), save_iterations=(), checkpoint_iterations=(), quiet=True,
        profile_dir=str(tmp_path / "trace"), profile_from=1, profile_steps=3)
    plain_step, steps = loop.tr.train_step_rgb, []

    def failing_step(*args, **kwargs):
        steps.append(1)
        if len(steps) == 2:
            raise RuntimeError("blend_bwd kernel launch failed")
        return plain_step(*args, **kwargs)

    monkeypatch.setattr(loop.tr, "train_step_rgb", failing_step)
    port = free_port()
    with pytest.raises(RuntimeError, match="launch failed"):
        loop.training(cfg, device="cpu", gui_port=port)
    assert len(steps) == 2
    assert not torch.autograd.profiler._is_profiler_enabled
    with socket.socket() as again:
        again.bind(("127.0.0.1", port))
