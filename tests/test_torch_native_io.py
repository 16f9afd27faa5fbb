"""PyTorch port, native language-feature loader (`langsplat_tpu_torch/native/`): bit-equal
to the numpy oracle and to the JAX package's native loader over int16/32/64 segment
maps and float16/32 tables; the npy shape probe; inputs it cannot serve; the camera
path taking the native loader (counted in `cameras.FEATURE_LOADS`) and numpy for the
rest; a failed build raising with the compiler's output; and the prefetcher's
done-callback with native loads that finish at once."""

import threading

import numpy as np
import pytest
import torch

from langsplat_tpu import native as jax_native
from langsplat_tpu_torch import native
from langsplat_tpu_torch.data import cameras

from tests.test_native_io import _numpy_oracle, _write_scene

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)


@pytest.mark.parametrize("seg_dtype", [np.int16, np.int32, np.int64])
@pytest.mark.parametrize("feat_dtype", [np.float16, np.float32])
def test_native_matches_numpy_and_jax(tmp_path, seg_dtype, feat_dtype):
    seg, feat = _write_scene(tmp_path, seg_dtype=seg_dtype, feat_dtype=feat_dtype)
    sp, fp = str(tmp_path / "view0_s.npy"), str(tmp_path / "view0_f.npy")
    for level in range(4):
        args = (sp, fp, level, seg.shape[1], seg.shape[2], feat.shape[1])
        got = native.gather_language_feature(*args)
        assert got is not None
        for want in (_numpy_oracle(seg, feat, level),
                     jax_native.gather_language_feature(*args)):
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
            assert got[0].dtype == got[1].dtype == np.float32
    # any thread count gives the same bits
    single = native.gather_language_feature(*args, num_threads=1)
    np.testing.assert_array_equal(single[0], got[0])


def test_npy_shape_probe(tmp_path):
    _write_scene(tmp_path, h=9, w=11, m=5, f=4)
    for name, want in (("view0_s.npy", ((4, 9, 11), "i4")), ("view0_f.npy", ((5, 4), "f2"))):
        path = str(tmp_path / name)
        assert native.npy_shape(path) == want == jax_native.npy_shape(path)
    assert native.npy_shape(str(tmp_path / "missing.npy")) is None


def test_native_refuses_what_it_cannot_serve(tmp_path):
    seg, feat = _write_scene(tmp_path)
    h, w, f = seg.shape[1], seg.shape[2], feat.shape[1]
    sp, fp = str(tmp_path / "view0_s.npy"), str(tmp_path / "view0_f.npy")
    assert native.gather_language_feature(sp, fp, 0, h + 1, w, f) is None   # resolution
    assert native.gather_language_feature(sp, fp, 7, h, w, f) is None       # level
    np.save(tmp_path / "bad_s.npy", np.zeros((4, h, w), np.float32))        # float seg
    assert native.gather_language_feature(str(tmp_path / "bad_s.npy"), fp, 0, h, w,
                                          f) is None
    (tmp_path / "junk_s.npy").write_bytes(b"not numpy at all")
    assert native.gather_language_feature(str(tmp_path / "junk_s.npy"), fp, 0, h, w,
                                          f) is None


def camera(name, w, h):
    return cameras.Camera(uid=0, colmap_id=0, R=np.eye(3), T=np.zeros(3), fov_x=0.8,
                          fov_y=0.8, image=None, image_name=name, width=w, height=h)


def loads_through(monkeypatch):
    counts = {"native": 0, "numpy": 0}
    monkeypatch.setattr(cameras, "FEATURE_LOADS", counts)
    return counts


def test_camera_path_takes_the_native_loader(tmp_path, monkeypatch):
    """Camera.get_language_feature equals the JAX package's (float16 specials
    included) through the native loader; a resolution mismatch, a 3-d table and a
    uint8 seg map take the numpy path, also equal to JAX's."""
    from langsplat_tpu.data.cameras import Camera as JaxCamera

    h, w, m, f = 24, 32, 9, 3
    rng = np.random.default_rng(3)
    seg = rng.integers(-1, m, size=(4, h, w)).astype(np.int32)
    feat = rng.normal(size=(m, f)).astype(np.float16)
    feat[0, 0] = np.float16(np.inf)
    feat[1, 1] = np.float16(6e-8)  # subnormal half
    np.save(tmp_path / "cam0_s.npy", seg)
    np.save(tmp_path / "cam0_f.npy", feat)
    np.save(tmp_path / "flat_s.npy", seg)
    np.save(tmp_path / "flat_f.npy", feat.reshape(m, 1, f))
    np.save(tmp_path / "bytes_s.npy", np.clip(seg, 0, None).astype(np.uint8))
    np.save(tmp_path / "bytes_f.npy", feat)

    def jax_feature(name, width, height):
        cam = JaxCamera(uid=0, colmap_id=0, R=np.eye(3), T=np.zeros(3), fov_x=0.8,
                        fov_y=0.8, image=None, image_name=name, width=width, height=height)
        return cam.get_language_feature(str(tmp_path), 2)

    counts = loads_through(monkeypatch)
    got = camera("cam0", w, h).get_language_feature(str(tmp_path), 2)
    assert counts == {"native": 1, "numpy": 0}
    for a, b in zip(got, jax_feature("cam0", w, h)):
        np.testing.assert_array_equal(a, b)
    assert np.isinf(got[0]).any()

    with pytest.warns(UserWarning, match="nearest-resizing"):
        got = camera("cam0", w // 2, h // 2).get_language_feature(str(tmp_path), 2)
    with pytest.warns(UserWarning, match="nearest-resizing"):
        want = jax_feature("cam0", w // 2, h // 2)
    assert counts == {"native": 1, "numpy": 1}
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # a uint8 seg map: numpy serves it
    got = camera("bytes", w, h).get_language_feature(str(tmp_path), 2)
    for a, b in zip(got, jax_feature("bytes", w, h)):
        np.testing.assert_array_equal(a, b)
    # a 3-d table: numpy fails as the JAX package's numpy path does
    with pytest.raises(ValueError, match="broadcast"):
        camera("flat", w, h).get_language_feature(str(tmp_path), 2)
    with pytest.raises(ValueError, match="broadcast"):
        jax_feature("flat", w, h)
    assert counts == {"native": 1, "numpy": 3}


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    broken = tmp_path / "langsplat_io.cpp"
    broken.write_text("extern \"C\" int ls_npy_shape( { this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="building the native loader failed") as err:
        native.npy_shape(str(tmp_path / "any.npy"))
    assert "error" in str(err.value)
    assert not list((tmp_path / "_build").glob("*.so"))


def test_prefetcher_with_native_loads_that_finish_at_once(tmp_path):
    """The prefetcher's done-callback (registered outside its lock) holds when the
    native load has finished before `schedule` registers it: many views, each load a
    few microseconds, scheduled and read from two threads."""
    from langsplat_tpu_torch.data.prefetch import FeaturePrefetcher

    views = 40
    for i in range(views):
        _write_scene(tmp_path, h=4, w=5, m=3, seed=i, name=f"v{i}")
    cams = [camera(f"v{i}", 5, 4) for i in range(views)]
    pf = FeaturePrefetcher(str(tmp_path), 1, device=torch.device("cpu"), max_cache_bytes=0)
    errors = []

    def run(order):
        try:
            for cam in order:
                pf.schedule(cam)
                feat, mask = pf.get(cam)
                want = _numpy_oracle(np.load(tmp_path / f"{cam.image_name}_s.npy"),
                                     np.load(tmp_path / f"{cam.image_name}_f.npy"), 1)
                assert np.array_equal(feat.numpy(), want[0])
                assert np.array_equal(mask.numpy(), want[1])
        except Exception as e:     # reported below, from the test's thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(o,), daemon=True)
               for o in (cams, cams[::-1])]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    pf.close()
