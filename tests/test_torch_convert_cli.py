"""PyTorch port, COLMAP converter (`cli/convert_cli.py`) against the JAX package's, with
a stub `colmap` that logs its arguments and writes what each step would: both CLIs run
the same commands, leave the same `sparse/0` layout and the same `images_{2,4,8}`, and
exit with the same code when a command fails."""

import os
import stat
import sys

import numpy as np
import pytest
from PIL import Image

from langsplat_tpu.cli.convert_cli import main as jax_convert_main
from langsplat_tpu_torch.cli.convert_cli import main as torch_convert_main

STUB = """#!{python}
import os, shutil, sys
args = sys.argv[1:]
with open(os.environ["COLMAP_LOG"], "a") as f:
    f.write(" ".join(args) + "\\n")
step = args[0]
if step == os.environ.get("COLMAP_FAIL"):
    sys.exit(3)
opt = dict(zip(args[1::2], args[2::2]))
if step == "mapper":
    os.makedirs(os.path.join(opt["--output_path"], "0"), exist_ok=True)
elif step == "image_undistorter":
    out = opt["--output_path"]
    os.makedirs(os.path.join(out, "sparse"), exist_ok=True)
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        with open(os.path.join(out, "sparse", name), "w") as f:
            f.write(name)
    shutil.copytree(opt["--image_path"], os.path.join(out, "images"), dirs_exist_ok=True)
"""


def write_scene(root):
    os.makedirs(os.path.join(root, "input"))
    rng = np.random.default_rng(0)
    for i, (w, h) in enumerate(((64, 48), (50, 37))):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(root, "input", f"img_{i}.png"))


def stub_colmap(tmp_path, name="colmap"):
    bindir = tmp_path / "bin"
    bindir.mkdir(exist_ok=True)
    path = bindir / name
    path.write_text(STUB.format(python=sys.executable))
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return bindir, path


def tree(root):
    """Relative path -> file bytes (PNG files as decoded pixels and size)."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            rel = os.path.relpath(p, root)
            if f.endswith(".png"):
                with Image.open(p) as im:
                    out[rel] = (im.size, np.asarray(im).tobytes())
            else:
                with open(p, "rb") as fh:
                    out[rel] = fh.read()
    return out


def run_both(tmp_path, monkeypatch, flags, fail=""):
    """Run each CLI on its own copy of the scene; returns per CLI (exit code, logged
    commands with the scene path replaced, the scene's tree)."""
    bindir, exe = stub_colmap(tmp_path)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("COLMAP_FAIL", fail)
    flags = [str(exe) if f == "<exe>" else f for f in flags]
    results = []
    for name, main in (("jax", jax_convert_main), ("port", torch_convert_main)):
        scene = str(tmp_path / name)
        write_scene(scene)
        log = tmp_path / f"{name}.log"
        monkeypatch.setenv("COLMAP_LOG", str(log))
        code = 0
        try:
            main(["-s", scene, *flags])
        except SystemExit as e:
            code = e.code
        commands = log.read_text().replace(scene, "<scene>").splitlines()
        results.append((code, commands, tree(scene)))
    return results


@pytest.mark.parametrize("flags", [
    [], ["--resize"], ["--skip_matching", "--no_gpu"],
    ["--colmap_executable", "<exe>", "--camera", "PINHOLE", "--resize"]])
def test_convert_cli_matches_jax(tmp_path, monkeypatch, flags):
    (jcode, jcmds, jtree), (tcode, tcmds, ttree) = run_both(tmp_path, monkeypatch, flags)
    assert jcode == tcode == 0
    assert tcmds == jcmds
    assert len(tcmds) == (1 if "--skip_matching" in flags else 4)
    assert ttree == jtree
    assert {k for k in ttree if k.startswith("sparse")} == {
        os.path.join("sparse", "0", n) for n in ("cameras.bin", "images.bin",
                                                 "points3D.bin")}
    resized = [k for k in ttree if k.startswith("images_")]
    assert len(resized) == (6 if "--resize" in flags else 0)
    if "--resize" in flags:
        assert ttree[os.path.join("images_4", "img_1.png")][0] == (50 // 4, 37 // 4)


def test_a_failing_command_exits_with_its_code(tmp_path, monkeypatch):
    (jcode, jcmds, _), (tcode, tcmds, _) = run_both(tmp_path, monkeypatch, [],
                                                    fail="mapper")
    assert jcode == tcode == 3
    assert tcmds == jcmds and tcmds[-1].startswith("mapper")
