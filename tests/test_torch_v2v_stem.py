"""V2V-PoseNet's stem convolution with its weight gradient over the set
voxels (deepprior_tpu_torch/ops/hopper_stem.py, the kernel K9 in
csrc/stem_wgrad.cu) on the CPU: what can be checked without the card.

- The plain gather ``stem_wgrad_plain`` equals ``torch.nn.grad.
  conv3d_weight`` in float64 at 0, about 0.2%, 5% and 100% occupancy,
  binary and non-binary, on 8^3, 16^3 and 24^3 grids at B = 1 and 3, and
  with set voxels on every face, edge and corner, where the 7^3 window is
  clipped: within 1e-12 of sum |x dy| for each weight (float64 round-off
  of two orders of one sum).
- ``StemConv`` (weight, bias and, when asked, input gradients) against
  autograd of ``F.conv3d``, in float32 and bfloat16.
- The route: the plain gather on a CPU tensor; on a CUDA tensor (faked,
  shapes and devices without a card) the kernel, launched once a backward.
- ``build()`` binds the C signature of csrc/stem_wgrad.cu as written
  there; the launch's arguments refuse a wrong dtype, shape or layout.
- ``V2VPoseNet``'s stem goes through the gather, under the parameter names
  it had.
The kernel itself runs only on a CUDA card: chip_smoke.py phase 51 holds
it to the plain gather.
"""

import ctypes
import itertools

import pytest
import torch
import torch.nn.functional as F

from deepprior_tpu_torch.models import V2VConfig, V2VPoseNet
from deepprior_tpu_torch.ops import _build, hopper_stem
from deepprior_tpu_torch.ops.hopper_stem import StemArgs, stem_conv3d, stem_wgrad_plain
from test_torch_augment_kernel import _c_signature, _StubLib

W_SHAPE = hopper_stem.WEIGHT_SHAPE


def _grid(b, g, occupancy, values, seed, dtype=torch.float64):
    """(b, 1, g, g, g): a share ``occupancy`` of the voxels set, to 1 or,
    with ``values``, to magnitudes in [0.5, 1.5) of either sign."""
    gen = torch.Generator().manual_seed(seed)
    shape = (b, 1, g, g, g)
    x = (torch.rand(shape, generator=gen, dtype=torch.float64) < occupancy).to(torch.float64)
    if values:
        mag = torch.rand(shape, generator=gen, dtype=torch.float64) + 0.5
        sign = torch.where(torch.rand(shape, generator=gen, dtype=torch.float64) < 0.5, -1.0, 1.0)
        x = x * mag * sign
    return x.to(dtype)


def _boundary(b, g):
    """Set voxels at the 8 corners, the 12 edges' middles and the 6 faces'
    centres of each sample's grid, and one inside."""
    x = torch.zeros((b, 1, g, g, g), dtype=torch.float64)
    ends, mid = (0, g - 1), g // 2
    for p in itertools.product((0, mid, g - 1), repeat=3):
        if sum(c in ends for c in p) >= 1:
            x[:, 0, p[0], p[1], p[2]] = 1.0
    x[:, 0, mid, mid, mid] = 2.0
    x[-1, 0, 1, g - 2, 3] = -0.75  # a sample apart from the first
    return x


def _dy(x, dtype=torch.float64, seed=9):
    gen = torch.Generator().manual_seed(seed)
    b, _, d, h, w = x.shape
    return torch.randn((b, hopper_stem.CHANNELS, d, h, w), generator=gen,
                       dtype=torch.float64).to(dtype)


def _scale(x, dy):
    """sum |x dy| for each weight: what the round-off of its sum is
    relative to."""
    return torch.nn.grad.conv3d_weight(x.double().abs(), W_SHAPE, dy.double().abs(),
                                       padding=hopper_stem.PAD)


CASES = [pytest.param(g, b, occ, values, id=f"G{g}-B{b}-{occ:g}-{'values' if values else 'binary'}")
         for g, b in ((8, 1), (16, 3), (24, 1)) for occ in (0.0, 0.002, 0.05, 1.0)
         for values in (False, True)]


@pytest.mark.parametrize("g, b, occupancy, values", CASES)
def test_plain_weight_grad_equals_conv3d_weight(g, b, occupancy, values):
    x = _grid(b, g, occupancy, values, seed=g + b)
    dy = _dy(x)
    got = stem_wgrad_plain(x, dy)
    want = torch.nn.grad.conv3d_weight(x, W_SHAPE, dy, padding=hopper_stem.PAD)
    assert got.shape == W_SHAPE and got.dtype == torch.float64
    assert torch.all((got - want).abs() <= 1e-12 * _scale(x, dy))
    if occupancy == 0.0:
        assert torch.equal(got, torch.zeros(W_SHAPE, dtype=torch.float64))


@pytest.mark.parametrize("g", [8, 16, 24])
def test_plain_weight_grad_clips_the_window_at_faces_edges_and_corners(g):
    x = _boundary(3, g)
    dy = _dy(x, seed=g)
    got = stem_wgrad_plain(x, dy)
    want = torch.nn.grad.conv3d_weight(x, W_SHAPE, dy, padding=hopper_stem.PAD)
    assert torch.all((got - want).abs() <= 1e-12 * _scale(x, dy))
    # a corner voxel alone reaches only the taps that keep q - k + 3 inside
    corner = torch.zeros((1, 1, g, g, g), dtype=torch.float64)
    corner[0, 0, 0, 0, 0] = 1.0
    ones = torch.ones((1, hopper_stem.CHANNELS, g, g, g), dtype=torch.float64)
    taps = stem_wgrad_plain(corner, ones)[0, 0]
    k = torch.arange(hopper_stem.SIDE)
    reach = (k <= hopper_stem.PAD)
    assert torch.equal(taps != 0, reach[:, None, None] & reach[None, :, None]
                       & reach[None, None, :])


# float32: the weight gradient sums in another order than cuDNN's or
# oneDNN's, so 1e-5 of sum |x dy|; the bias is the same dense sum, 1e-6 of
# sum |dy|; the input gradient is the same call autograd makes, 1e-6.
# bfloat16, against float32 autograd of the same bfloat16 values: the
# weight and bias gradients are float32 sums rounded once to bfloat16, so
# 2^-8 of the value (one ulp) besides; the input gradient is oneDNN's
# bfloat16 convolution on both sides, 2^-7 of sum |w dy| (its rounding of
# the products' sum and of the output).
TOLERANCE = {torch.float32: (1e-5, 0.0, 1e-6), torch.bfloat16: (1e-5, 2.0 ** -8, 2.0 ** -7)}


@pytest.mark.parametrize("input_grad", [False, True], ids=["weights", "weights_and_input"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_function_matches_autograd_of_conv3d(dtype, input_grad):
    rel, ulp, dx_rel = TOLERANCE[dtype]
    x0 = _grid(2, 16, 0.05, values=False, seed=4, dtype=dtype)
    dy = _dy(x0, dtype)
    gen = torch.Generator().manual_seed(5)
    w0 = (torch.randn(W_SHAPE, generator=gen) * 0.05).to(dtype)
    b0 = (torch.randn(hopper_stem.CHANNELS, generator=gen) * 0.05).to(dtype)

    def grads(fn, cast):
        x = x0.to(cast).clone().requires_grad_(input_grad)
        w = w0.to(cast).clone().requires_grad_(True)
        b = b0.to(cast).clone().requires_grad_(True)
        y = fn(x, w, b)
        y.backward(dy.to(cast))
        return y, x.grad, w.grad, b.grad

    y, dx, dw, db = grads(stem_conv3d, dtype)
    ref_dtype = torch.float32
    y_ref, dx_ref, dw_ref, db_ref = grads(lambda x, w, b: F.conv3d(x, w, b, padding=3), ref_dtype)
    assert torch.equal(y, F.conv3d(x0, w0, b0, padding=3))  # the forward is F.conv3d's
    assert dw.dtype == db.dtype == dtype and dw.shape == W_SHAPE
    scale = _scale(x0, dy).float()
    assert torch.all((dw.float() - dw_ref).abs() <= rel * scale + ulp * dw_ref.abs())
    db_scale = dy.float().abs().sum(dim=(0, 2, 3, 4))
    assert torch.all((db.float() - db_ref).abs() <= 1e-6 * db_scale + ulp * db_ref.abs())
    if not input_grad:
        assert dx is None
        return
    if dtype == torch.bfloat16:  # the same bfloat16 convolution autograd would run
        dx_ref = grads(lambda x, w, b: F.conv3d(x, w, b, padding=3), dtype)[1]
    dx_scale = torch.nn.grad.conv3d_input(x0.shape, w0.double().abs(), dy.double().abs(),
                                          padding=3).float()
    assert dx.dtype == dtype
    assert torch.all((dx.float() - dx_ref.float()).abs() <= dx_rel * dx_scale)


def test_weight_grad_routes_by_device(monkeypatch):
    """A CPU tensor takes the plain gather and never the kernel; a CUDA
    tensor (faked: shapes and devices without a card) takes the kernel
    once a backward, and never the gather; the bias gradient stays the
    dense sum and no input gradient is computed for the grid.  (The CUDA
    backward is called directly: autograd's engine would start a device
    thread for the fake card.)"""
    from types import SimpleNamespace

    from torch._subclasses.fake_tensor import FakeTensorMode

    launched, gathered = [], []
    plain = hopper_stem.stem_wgrad_plain

    def fake_launch(args):
        launched.append(args)
        return args.out

    monkeypatch.setattr(hopper_stem, "launch_stem_wgrad", fake_launch)
    monkeypatch.setattr(hopper_stem, "stem_wgrad_plain",
                        lambda *a: gathered.append(1) or plain(*a))
    monkeypatch.setattr(torch.nn.grad, "conv3d_input",
                        lambda *a, **k: pytest.fail("the grid's gradient was computed"))
    x = _grid(2, 8, 0.05, values=False, seed=1, dtype=torch.float32)
    w = torch.zeros(W_SHAPE, requires_grad=True)
    b = torch.zeros(hopper_stem.CHANNELS, requires_grad=True)
    stem_conv3d(x, w, b).sum().backward()
    assert gathered == [1] and launched == []
    assert torch.equal(b.grad, torch.full((16,), 2.0 * 8 ** 3))
    gathered.clear()
    with FakeTensorMode(allow_non_fake_inputs=True):
        xc = torch.empty((2, 1, 16, 16, 16), device="cuda")
        wc = torch.empty(W_SHAPE, device="cuda")
        dy = torch.empty((2, 16, 16, 16, 16), device="cuda")
        ctx = SimpleNamespace(saved_tensors=(xc, wc), needs_input_grad=(False, True, True))
        dx, dw, db = hopper_stem.StemConv.backward(ctx, dy)
        assert dx is None and dw.device.type == "cuda" and dw.shape == W_SHAPE
        assert db.shape == (hopper_stem.CHANNELS,)
    assert gathered == [] and len(launched) == 1
    (args,) = launched
    assert args.x.shape == (2, 1, 16, 16, 16) and args.dy.shape == (2, 16, 16, 16, 16)
    assert args.partial.shape == (min(hopper_stem.BLOCKS, 2 * 8), 16 * 343)
    assert args.partial.dtype == torch.float32 and args.out.shape == W_SHAPE


def test_stem_build_binds_the_c_signature(monkeypatch):
    """``dp_stem_wgrad``: the four buffers and the stream as c_void_p, the
    element width, the grid of blocks and the sizes as c_int, in the order
    csrc/stem_wgrad.cu declares them."""
    monkeypatch.setattr(_build, "load_library", lambda source: _StubLib())
    hopper_stem.build.cache_clear()
    try:
        lib = hopper_stem.build()
        want = _c_signature("dp_stem_wgrad", "stem_wgrad.cu")
        assert list(lib.dp_stem_wgrad.argtypes) == want
        assert want == [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        assert lib.dp_stem_wgrad.restype is ctypes.c_int
        assert lib.dp_error_string.restype is ctypes.c_char_p
    finally:
        hopper_stem.build.cache_clear()


def _refusal(kind):
    """(callable, exception, message) of one refusal."""
    x = torch.zeros((2, 1, 8, 8, 8))
    dy = torch.zeros((2, 16, 8, 8, 8))
    args = hopper_stem.stem_wgrad_args(x, dy)
    return {
        "float64": (lambda: hopper_stem.stem_wgrad_args(x.double(), dy.double()),
                    TypeError, "float32"),
        "mixed dtypes": (lambda: hopper_stem.stem_wgrad_args(x, dy.bfloat16()),
                         TypeError, "float32"),
        "two input channels": (lambda: hopper_stem.stem_wgrad_args(
            torch.zeros((2, 2, 8, 8, 8)), dy), ValueError, "input"),
        "eight output channels": (lambda: hopper_stem.stem_wgrad_args(
            x, torch.zeros((2, 8, 8, 8, 8))), ValueError, "output gradient"),
        "another grid": (lambda: hopper_stem.stem_wgrad_args(
            x, torch.zeros((2, 16, 8, 8, 16))), ValueError, "output gradient"),
        "a 4-D grid": (lambda: stem_wgrad_plain(x[:, 0], dy), ValueError, "input"),
        "a scratch of another size": (lambda: hopper_stem.launch_stem_wgrad(
            args._replace(partial=torch.empty((3, 5488)))), ValueError, "scratch"),
        "an output of another shape": (lambda: hopper_stem.launch_stem_wgrad(
            args._replace(out=torch.empty((16, 343)))), ValueError, "out"),
        "a float64 output": (lambda: hopper_stem.launch_stem_wgrad(
            args._replace(out=args.out.double())), TypeError, "one dtype"),
        "non-contiguous dy": (lambda: hopper_stem.launch_stem_wgrad(args._replace(
            dy=torch.zeros((2, 8, 8, 8, 16)).permute(0, 4, 1, 2, 3))), ValueError, "contiguous"),
        "CPU tensors": (lambda: hopper_stem.launch_stem_wgrad(args), ValueError, "CUDA"),
        "another weight": (lambda: stem_conv3d(x, torch.zeros((16, 1, 5, 5, 5)),
                                               torch.zeros(16)), ValueError, "weight"),
    }[kind]


@pytest.mark.parametrize("kind", ["float64", "mixed dtypes", "two input channels",
                                  "eight output channels", "another grid", "a 4-D grid",
                                  "a scratch of another size", "an output of another shape",
                                  "a float64 output", "non-contiguous dy", "CPU tensors",
                                  "another weight"])
def test_arguments_refuse_what_the_kernel_does_not_take(kind):
    fn, exc, match = _refusal(kind)
    with pytest.raises(exc, match=match):
        fn()


def test_arguments_take_non_contiguous_inputs_contiguous():
    """The launch's arguments: contiguous copies, the grid of blocks capped
    at the bricks, the scratch float32 and the output in dy's dtype."""
    dy = torch.zeros((1, 8, 8, 8, 16), dtype=torch.bfloat16).permute(0, 4, 1, 2, 3)
    x = torch.zeros((1, 1, 8, 8, 8), dtype=torch.bfloat16)
    args = hopper_stem.stem_wgrad_args(x, dy)
    assert not dy.is_contiguous() and args.dy.is_contiguous()
    assert torch.equal(args.dy, dy)
    assert args.partial.shape == (1, 5488) and args.partial.dtype == torch.float32
    assert args.out.dtype == torch.bfloat16 and args.out.shape == W_SHAPE
    assert hopper_stem.bricks(torch.zeros((3, 1, 88, 88, 88))) == 3 * 11 ** 3
    assert isinstance(args, StemArgs)


def test_v2v_stem_goes_through_the_gather(monkeypatch):
    """One backward of the network gathers the stem's weight gradient once;
    the parameter names and shapes are those of Basic(1, 16, 7), so state
    dicts written before load as they are."""
    calls = []
    plain = hopper_stem.stem_wgrad_plain
    monkeypatch.setattr(hopper_stem, "stem_wgrad_plain", lambda *a: calls.append(1) or plain(*a))
    net = V2VPoseNet(V2VConfig(grid=16, cube_voxels=24),
                     generator=torch.Generator().manual_seed(0))
    sd = net.state_dict()
    assert sd["stem.conv.weight"].shape == W_SHAPE and sd["stem.conv.bias"].shape == (16,)
    assert [k for k in sd if k.startswith("stem.")] == [
        "stem.conv.weight", "stem.conv.bias", "stem.bn.weight", "stem.bn.bias",
        "stem.bn.running_mean", "stem.bn.running_var"]
    x = _grid(2, 16, 0.05, values=False, seed=2, dtype=torch.float32)
    net(x).square().sum().backward()
    assert calls == [1]
    assert net.stem.conv.weight.grad.shape == W_SHAPE
