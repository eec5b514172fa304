"""The measurement probes K6 and K7 of the port against the TPU probes.

The TPU probes live in scripts that time themselves at full size when
imported (prof_bench.py, prof_warp_bf16.py), so this file executes only
their imports, name constants and defs, parsed with ``ast``, into a
namespace whose B, H, W and band are small, and runs the probes there
under ``pltpu.force_tpu_interpret_mode()``:

- K6a (run_trivial) and K6b (run_mm, HIGHEST) equal the port's plain
  versions bit for bit, at offsets (0, 0) and (8, 128);
- K6c (run_mm_def): on a TPU DEFAULT precision is one bf16 pass, so the
  output is band[64, 32] rounded to bf16; on the CPU, XLA's DEFAULT dot is
  float32, so the interpret output is the exact value, and the port's
  plain version equals it rounded to bf16;
- K7 (make('f32'), make('split')) at 32x32 and 64x64 (ROW_CHUNK = 32):
  within the flip bound of tests/test_torch_warp.py (XLA may fuse the
  coordinate's multiply-adds into FMAs and flip a half-integer: at most
  max(1e-4 of the pixels, 2) differ), the identity bit for bit.
The kernels run only on a CUDA card; chip_smoke.py holds them bit for bit
against these plain versions.
"""

import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from deepprior_tpu.geometry import rotation_matrix_2d as j_rotation

from deepprior_tpu_torch.ops import hopper_probes as hp
from deepprior_tpu_torch.ops.hopper_warp import warp_patch_params
from deepprior_tpu_torch.prof import prof_bench, prof_warp_bf16

ROOT = os.path.join(os.path.dirname(__file__), "..")
B, FH, FW, BAND = 2, 136, 256, (128, 128)
OFFSETS = np.array([[0, 0], [8, 128]], np.float32)


def _load_probe(name, **small):
    """The imports, name constants and defs of the TPU probe script
    ``name``, executed without its timing code, with ``small`` overriding
    its constants."""
    path = os.path.join(ROOT, name)
    with open(path) as f:
        tree = ast.parse(f.read())
    keep = []
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom, ast.FunctionDef)):
            keep.append(node)
        elif isinstance(node, ast.Assign) and all(
                isinstance(t, (ast.Name, ast.Tuple)) for t in node.targets):
            try:
                ast.literal_eval(node.value)
            except ValueError:
                continue
            keep.append(node)
    ns = {}
    exec(compile(ast.Module(keep, type_ignores=[]), path, "exec"), ns)
    ns.update(small)
    return ns


@pytest.fixture(scope="module")
def bench_probe():
    return _load_probe("prof_bench.py", B=B, H=FH, W=FW, WH=BAND[0], WW=BAND[1])


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(0)
    return rng.random((B, FH, FW)).astype(np.float32) * 1000


_RUNS = {"trivial": "run_trivial", "select": "run_mm", "select_bf16": "run_mm_def"}


@pytest.mark.parametrize("body", list(_RUNS))
def test_band_plain_matches_interpret(bench_probe, frames, body):
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(bench_probe[_RUNS[body]](jnp.asarray(frames),
                                                   jnp.asarray(OFFSETS)))
    got = hp.band_probe(torch.from_numpy(frames), OFFSETS, BAND, body).numpy()
    assert got.shape == want.shape == (B, hp.CORNER, hp.CORNER)
    if body == "select_bf16":
        # XLA's DEFAULT dot on the CPU is float32; the TPU's is one bf16 pass
        exact, want = want, torch.tensor(want).to(torch.bfloat16).float().numpy()
        assert not np.array_equal(got, exact)
    np.testing.assert_array_equal(got, want)
    if body == "trivial":
        np.testing.assert_array_equal(got[1], frames[1, 8:136, 128:256])


def _rotations(b, size, seed):
    rng = np.random.default_rng(seed)
    c = np.array([size / 2, size / 2], np.float32)
    ms = [np.eye(3, dtype=np.float32)]
    for ang in (90.0, 180.0, -33.0, 117.5, *rng.uniform(-180, 180, b - 5)):
        ms.append(np.asarray(j_rotation(c, np.float32(ang)), np.float32))
    return np.stack(ms)


@pytest.mark.parametrize("size", [32, 64])
@pytest.mark.parametrize("variant", ["f32", "split"])
def test_warp_general_plain_matches_interpret(size, variant):
    probe = _load_probe("prof_warp_bf16.py", B=8, H=size, W=size)
    assert probe["ROW_CHUNK"] == 32
    m = _rotations(8, size, seed=size)
    p = np.random.default_rng(1).uniform(400, 900, (8, size, size)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(probe["make"](variant)(jnp.asarray(p), jnp.asarray(m)))
    got = hp.warp_general(torch.from_numpy(p), torch.from_numpy(m),
                          split=variant == "split").numpy()
    bad = int(np.sum(got != want))
    assert bad <= max(1e-4 * got.size, 2), f"{bad} of {got.size} pixels differ"
    np.testing.assert_array_equal(got[0], p[0])  # the identity
    np.testing.assert_array_equal(want[0], p[0])
    assert (got[1:] == 0.0).any()  # rotated corners leave the patch


def test_split_equals_f32_on_the_probe_inputs():
    """On the probe's own inputs (values in [400, 900), three bf16 parts
    hold every float32 mantissa) the split rebuilds each value exactly."""
    patch, m = prof_warp_bf16.make_inputs("cpu")
    assert patch.shape == (128, 128, 128)
    params = warp_patch_params(m)
    f32 = hp.warp_general_plain(patch, params)
    split = hp.warp_general_plain(patch, params, split=True)
    assert torch.equal(f32, split)
    assert torch.equal(hp.warp_general(patch, m, split=True), f32)
    # each part alone is not the value: the split is a real three-part sum
    assert not torch.equal(patch.to(torch.bfloat16).float(), patch)


def test_band_probe_inputs_and_bytes(monkeypatch):
    assert (prof_bench.B, prof_bench.H, prof_bench.W) == (512, 480, 640)
    assert (prof_bench.WH, prof_bench.WW) == (304, 512)
    monkeypatch.setattr(prof_bench, "B", 2)  # the full 629 MB is the card's
    dpt, offsets = prof_bench.make_inputs("cpu")
    assert dpt.shape == (2, 480, 640) and not offsets.any()
    assert offsets.dtype == torch.int32
    # the TPU probe's frames, from the same seed
    want = np.random.default_rng(0).random((2, 480, 640)).astype(np.float32) * 1000
    np.testing.assert_array_equal(dpt.numpy(), want)
    shape, band = (512, 480, 640), (304, 512)
    assert hp.band_read_bytes(shape, band) == 512 * (304 * 512 * 4 + 8 + 128 * 128 * 4)
    assert hp.band_need_bytes(shape, "trivial") == 512 * (2 * 128 * 128 * 4 + 8)
    assert hp.band_need_bytes(shape, "select") == 512 * (4 + 8 + 128 * 128 * 4)
    # 318.8 MB of band and 33.5 MB of output at B = 512
    assert round(512 * 304 * 512 * 4 / 1e6, 1) == 318.8


@pytest.mark.parametrize("offsets, match", [
    ([[4, 0], [0, 0]], "multiples"),       # rows not a multiple of 8
    ([[0, 64], [0, 0]], "multiples"),      # columns not a multiple of 128
    ([[16, 0], [0, 0]], "leaves"),         # 16 + 128 > 136 rows
    ([[0, 0], [0, 256]], "leaves"),        # past the last column
    ([[-8, 0], [0, 0]], "leaves"),
    ([[0.5, 0], [0, 0]], "whole"),
    ([0, 0], r"\(B, 2\)"),
])
def test_band_wrapper_raises_on_bad_offsets(frames, offsets, match):
    with pytest.raises(ValueError, match=match):
        hp.band_probe(torch.from_numpy(frames), np.asarray(offsets, np.float32), BAND)


def test_wrappers_refuse_cpu_launches_and_unknown_bodies(frames):
    dpt = torch.from_numpy(frames)
    offs = torch.zeros((B, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        hp.launch_band(dpt, offs, BAND)
    with pytest.raises(ValueError, match="CUDA"):
        hp.launch_warp_general(torch.zeros((1, 8, 8)), torch.zeros((1, 6)))
    with pytest.raises(ValueError, match="body"):
        hp.band_probe(dpt, OFFSETS, BAND, body="matmul")
    with pytest.raises(ValueError, match="cpu or cuda"):
        hp.warp_general(torch.zeros((1, 8, 8), device="meta"), torch.eye(3)[None])


def test_band_build_binds_and_checks_constants(monkeypatch):
    """build() declares every pointer and the stream as c_void_p and the
    sizes as c_int, and refuses a library whose corner or selected pixel
    differ from the wrapper's (CORNER, SEL_ROW, SEL_COL)."""
    import ctypes

    from deepprior_tpu_torch.ops import _build

    class Fn:
        def __init__(self, ret):
            self.ret, self.argtypes, self.restype = ret, None, None

        def __call__(self, *args):
            return self.ret(*args)

    def stub(constants):
        lib = type("StubLib", (), {})()
        for name in ("dp_band_probe", "dp_warp_general", "dp_error_string"):
            setattr(lib, name, Fn(lambda *a: 0))
        lib.dp_constant = Fn(lambda i: constants[i] if i < len(constants) else -1)
        return lib

    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    good = stub((hp.CORNER, hp.SEL_ROW, hp.SEL_COL))
    monkeypatch.setattr(_build, "load_library", lambda source: good)
    hp.build.cache_clear()
    try:
        lib = hp.build()
        # dpt, offsets, out, b, h, w, band_h, band_w, body, stream
        assert lib.dp_band_probe.argtypes == [ptr] * 3 + [i32] * 6 + [ptr]
        assert lib.dp_band_probe.restype is i32
        # src, params, out, b, h, w, split, stream
        assert lib.dp_warp_general.argtypes == [ptr] * 3 + [i32] * 4 + [ptr]
        assert lib.dp_constant.argtypes == [i32]
        hp.build.cache_clear()
        bad = stub((hp.CORNER, hp.SEL_ROW + 1, hp.SEL_COL))
        monkeypatch.setattr(_build, "load_library", lambda source: bad)
        with pytest.raises(RuntimeError, match="sel_row"):
            hp.build()
    finally:
        hp.build.cache_clear()
