"""The port's native capture shim (deepprior_tpu_torch/cpp/capture.cpp, built
with g++ by ops/_build.py::host_library_path) and its ``CaptureDevice``
against the JAX package's ``CaptureDevice`` on the library tests/conftest.py
builds from deepprior_tpu/cpp/capture.cpp.

At 1 fps the shim publishes its first frame at once and the next a second
later, so both devices, started together, hold frame 0: every getter
(depth, colour, vertices int16 and float32, UV, sync, intrinsics,
extrinsics, acceleration) is compared bit for bit, unmirrored and
mirrored, in the synthetic and the file mode.
"""

import os
import struct

import numpy as np
import pytest

from deepprior_tpu.realtime.camera import CaptureDevice as JaxCaptureDevice

from deepprior_tpu_torch.ops import _build
from deepprior_tpu_torch.realtime.camera import CaptureDevice

JAX_LIB = os.path.join(os.path.dirname(__file__), "..", "deepprior_tpu", "cpp",
                       "libcapture.so")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """The port's shim built with g++ into a temporary build directory."""
    path = _build.host_library_path("capture.cpp", str(tmp_path_factory.mktemp("_build")))
    return path


def test_shim_builds_once_per_source(lib, tmp_path, monkeypatch):
    """The library is named by a hash of the source and the flags, built
    once (a second call returns the same file, no temporary left), and a
    source that does not compile raises with the compiler's message."""
    assert os.path.isfile(lib)
    name = os.path.basename(lib)
    assert name.startswith("libcapture-") and name.endswith(".so")
    assert _build.host_library_path("capture.cpp", os.path.dirname(lib)) == lib
    assert [f for f in os.listdir(os.path.dirname(lib)) if f.endswith(".tmp")] == []
    broken = tmp_path / "cpp"
    broken.mkdir()
    (broken / "capture.cpp").write_text("int broken( {\n")
    monkeypatch.setattr(_build, "CPP", str(broken))
    with pytest.raises(RuntimeError, match="failed"):
        _build.host_library_path("capture.cpp", str(tmp_path / "b"))
    assert not any(f.endswith(".so") for f in os.listdir(tmp_path / "b"))


def _getters(dev):
    """Every getter's output, in one order."""
    out = {}
    for name in ("getDepth", "getRGB", "getUVMap", "getSyncMap"):
        ok, arr = getattr(dev, name)()
        assert ok, name
        out[name] = arr
    for fp in (False, True):
        ok, arr = dev.getVertices(fp=fp)
        assert ok
        out[f"getVertices(fp={fp})"] = arr
    out["getAcceleration"] = dev.getAcceleration()
    out["getExtrinsics"] = dev.getExtrinsics()
    out["getDepthIntrinsics"] = np.array(dev.getDepthIntrinsics()[:4] + (
        dev.getDepthIntrinsics().width, dev.getDepthIntrinsics().height), np.float64)
    c = dev.getColorIntrinsics()
    out["getColorIntrinsics"] = np.array(c[:4] + (c.width, c.height), np.float64)
    out["counts"] = np.array([dev.getLastDepthNum() > 0, dev.getLastColorNum() > 0])
    return out


def _run_pair(lib, mirror, **kw):
    port = CaptureDevice(lib, fps=1.0, mirror=mirror, **kw)
    jax_dev = JaxCaptureDevice(JAX_LIB, fps=1.0, mirror=mirror, **kw)
    port.start()
    jax_dev.start()
    try:
        return _getters(port), _getters(jax_dev)
    finally:
        port.stop()
        jax_dev.stop()


@pytest.mark.parametrize("mirror", [False, True])
def test_synthetic_capture_matches_jax(lib, mirror):
    """Synthetic mode: every getter of frame 0 bit-equal to the JAX
    device's, with the shapes and dtypes of the reference's surface."""
    got, want = _run_pair(lib, mirror, mode="synthetic")
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["getDepth"].shape == (240, 320) and got["getDepth"].dtype == np.float32
    assert (got["getDepth"] > 0).sum() > 50
    assert got["getRGB"].shape == (480, 640, 3) and got["getRGB"].dtype == np.uint8
    assert got["getVertices(fp=False)"].dtype == np.int16
    assert got["getUVMap"].shape == (240, 320, 2)
    assert got["getExtrinsics"].shape == (3, 4) and got["getAcceleration"].shape == (3,)


def test_file_capture_matches_jax(lib, tmp_path):
    """File mode: the first replayed frame, bit-equal to the JAX device's
    and to the file's."""
    frames = np.random.default_rng(1).uniform(100, 900, (4, 16, 24)).astype(np.float32)
    path = tmp_path / "frames.bin"
    with open(path, "wb") as f:
        f.write(struct.pack("<3i", 16, 24, 4))
        frames.tofile(f)
    got, want = _run_pair(lib, False, mode="file", source=str(path))
    np.testing.assert_array_equal(got["getDepth"], want["getDepth"])
    np.testing.assert_array_equal(got["getDepth"], frames[0])
    np.testing.assert_array_equal(got["getVertices(fp=True)"], want["getVertices(fp=True)"])


def test_capture_errors(lib, tmp_path):
    """A file that is not a frame file fails to start (the shim's rc 2);
    getters before start report no frame."""
    bad = tmp_path / "bad.bin"
    bad.write_bytes(b"xx")
    dev = CaptureDevice(lib, mode="file", source=str(bad))
    assert dev.getDepth() == (False, None) and dev.getVertices() == (False, None)
    with pytest.raises(RuntimeError, match="rc=2"):
        dev.start()


def test_no_torn_reads_under_fast_writes(lib, tmp_path):
    """Constant-valued frames replayed at 10 kfps: every snapshot is
    uniform (a torn read would mix two frames' rows)."""
    h, w = 240, 320
    frames = np.stack([np.full((h, w), 500.0, np.float32), np.full((h, w), 900.0, np.float32)])
    path = tmp_path / "tear.bin"
    with open(path, "wb") as f:
        f.write(struct.pack("<3i", h, w, 2))
        frames.tofile(f)
    dev = CaptureDevice(lib, mode="file", source=str(path), fps=10000.0)
    dev.start()
    try:
        for _ in range(300):
            ok, frame = dev.getDepth()
            assert ok
            assert frame.min() == frame.max() and frame.min() in (500.0, 900.0)
    finally:
        dev.stop()
