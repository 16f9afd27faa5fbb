"""The PyTorch port stands alone: no module of `langsplat_tpu_torch/`, and nothing
`chip_smoke.py` imports, reaches JAX or the JAX package; and its entry points do not
fall back to the CPU quietly."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "langsplat_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "langsplat_tpu")


def forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    bad = [(str(f.relative_to(REPO)), m) for f in files for m in imported_modules(f)
           if forbidden(m)]
    assert bad == []
    assert not forbidden("langsplat_tpu_torch") and forbidden("langsplat_tpu.ops")


def test_importing_the_port_never_reaches_jax():
    """Import every module of the port, the CLI and chip_smoke.py in a fresh interpreter
    whose import system refuses JAX and the JAX package."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py"))
    code = f"""
import importlib, sys
FORBIDDEN = {FORBIDDEN!r}
class Refuse:
    def find_spec(self, name, path=None, target=None):
        if any(name == f or name.startswith(f + ".") for f in FORBIDDEN):
            raise ImportError("the port imported " + name)
        return None
sys.meta_path.insert(0, Refuse())
for m in {modules!r} + ["chip_smoke"]:
    importlib.import_module(m)
leaked = [m for m in sys.modules if any(m == f or m.startswith(f + ".") for f in FORBIDDEN)]
assert not leaked, leaked
print("imported", len({modules!r}) + 1)
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


def test_render_full_needs_a_card_unless_asked(monkeypatch):
    from langsplat_tpu_torch.config import PipelineConfig
    from langsplat_tpu_torch.device import resolve_device
    from langsplat_tpu_torch.train.loop import render_full

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_full(None, None, PipelineConfig(), 3, False, [0.0, 0.0, 0.0], device=None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_preprocessing_imports_neither_opencv_nor_matplotlib():
    """The preprocessing (SAM masks, NMS, tiles, files), its CLIP backends and CLI, and
    the CLIP text encoder: no import of cv2 or matplotlib anywhere in the modules (the
    eval imports matplotlib only to draw its localization PNGs; the subprocess tests
    run both CLIs under an importer that refuses both)."""
    files = (sorted((PORT / "preprocess").glob("*.py"))
             + [PORT / "cli" / "preprocess_cli.py", PORT / "evaluation" / "clip_text.py"])
    assert len(files) == 7
    bad = [(str(f.relative_to(REPO)), m) for f in files for m in imported_modules(f)
           if m.split(".")[0] in ("cv2", "matplotlib")]
    assert bad == []


def test_preprocessing_entry_points_need_a_card_unless_asked(monkeypatch, tmp_path):
    from langsplat_tpu_torch.evaluation.clip_text import ClipTextEncoder
    from langsplat_tpu_torch.preprocess import backends
    from langsplat_tpu_torch.preprocess.auto_mask import AutoMaskGenerator

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    unused = str(tmp_path)          # a local directory: nothing is ever fetched
    for make in (lambda: AutoMaskGenerator(lambda image, points: None),
                 lambda: backends.TransformersSamPredictor(unused),
                 lambda: backends.TransformersClipImageEncoder(unused),
                 lambda: ClipTextEncoder(unused)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert AutoMaskGenerator(None, device="cpu").device == torch.device("cpu")


def test_the_single_device_surface_stands_alone():
    """The metrics, the viewer bridge, the native loader, the tiled backend and the
    COLMAP converter are modules of the port (so the two tests above import and parse
    them), and the native build reads the port's own C++ source, which includes system
    headers only."""
    from langsplat_tpu_torch import native

    for rel in ("utils/metrics.py", "utils/network_gui.py", "native/__init__.py",
                "ops/rasterize_tiled.py", "cli/convert_cli.py"):
        path = PORT / rel
        assert path.exists(), rel
        assert not [m for m in imported_modules(path) if forbidden(m)], rel
    assert native.SOURCE == PORT / "native" / "langsplat_io.cpp"
    assert native.BUILD_DIR == PORT / "_build"
    includes = [line.split(None, 1)[1] for line in native.SOURCE.read_text().splitlines()
                if line.startswith("#include")]
    assert includes and all(i.startswith("<") for i in includes)
