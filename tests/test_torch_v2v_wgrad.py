"""V2V-PoseNet's dense convolutions with few channels, their weight gradient
the kernel K10 (deepprior_tpu_torch/ops/hopper_conv3d.py, csrc/
conv3d_wgrad.cu), on the CPU: what can be checked without the card.

- The plain weight gradient ``conv3d_wgrad_plain`` equals ``torch.nn.grad.
  conv3d_weight`` in float64 for 1^3 and 3^3 windows, 14, 16 and 32
  channels in and out, B = 1 and 3, on ragged volumes (9x10x12, 5x7x3):
  within 1e-12 of sum |x dy| for each weight (float64 round-off of two
  orders of one sum).
- ``Conv3dSame`` (weight, bias and, when asked, input gradients) against
  autograd of ``F.conv3d``, in float32 and bfloat16.
- The route: ``takes`` picks exactly V2V's fourteen convolutions at the
  dense level (ten 3^3, four 1^3), and a backward of the network computes
  fourteen weight gradients through the module, at that level; the stem,
  the transposed and the 64- and 128-channel convolutions stay F.conv3d's.
  On a CPU tensor the plain version; on a CUDA tensor (faked: shapes and
  devices without a card) the kernel, and where the kernel cannot be built
  the call raises, with no fallback.
- ``build()`` binds the C signature of csrc/conv3d_wgrad.cu as written
  there; the launch's arguments refuse a dtype, shape or layout the kernel
  does not take.
The kernel itself runs only on a CUDA card: chip_smoke.py phase 52 holds it
to the plain version.
"""

import contextlib
import ctypes
import warnings
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F
from torch import nn
from torch._subclasses.fake_tensor import FakeTensorMode

from deepprior_tpu_torch.models import V2VConfig, V2VPoseNet
from deepprior_tpu_torch.ops import _build, hopper_conv3d
from deepprior_tpu_torch.ops.hopper_conv3d import conv3d, conv3d_wgrad_plain
from test_torch_augment_kernel import _c_signature, _StubLib

# the fourteen convolutions at G/2 whose weight gradient K10 takes
DENSE = ["front.0.conv1", "front.0.conv2", "front.0.skip_conv", "front.1.conv1",
         "front.1.conv2", "front.2.conv1", "front.2.conv2", "skip1.conv1", "skip1.conv2",
         "back_res.conv1", "back_res.conv2", "back.0.conv", "back.1.conv", "out"]


def _pair(b, cin, cout, volume, seed, dtype=torch.float64):
    """x >= 0 (a ReLU's output) and a dy of either sign."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.relu(torch.randn((b, cin, *volume), generator=gen, dtype=torch.float64))
    dy = torch.randn((b, cout, *volume), generator=gen, dtype=torch.float64)
    return x.to(dtype), dy.to(dtype)


def _scale(x, dy, side):
    """sum |x dy| for each weight: what the round-off of its sum is
    relative to."""
    cin, cout = x.shape[1], dy.shape[1]
    return torch.nn.grad.conv3d_weight(x.double().abs(), (cout, cin, side, side, side),
                                       dy.double().abs(), padding=(side - 1) // 2)


CASES = [pytest.param(side, cin, cout, b, volume,
                      id=f"k{side}-{cin}to{cout}-B{b}-{'x'.join(map(str, volume))}")
         for side in (1, 3) for cin in (14, 16, 32) for cout in (14, 16, 32) for b in (1, 3)
         for volume in [(9, 10, 12) if b == 1 else (5, 7, 3)]]


@pytest.mark.parametrize("side, cin, cout, b, volume", CASES)
def test_plain_weight_grad_equals_conv3d_weight(side, cin, cout, b, volume):
    x, dy = _pair(b, cin, cout, volume, seed=side * 1000 + cin * 40 + cout + b)
    got = conv3d_wgrad_plain(x, dy, side)
    want = torch.nn.grad.conv3d_weight(x, (cout, cin, side, side, side), dy,
                                       padding=(side - 1) // 2)
    assert got.shape == (cout, cin, side, side, side) and got.dtype == torch.float64
    assert torch.all((got - want).abs() <= 1e-12 * _scale(x, dy, side))


def test_plain_weight_grad_pads_with_zeros_at_every_face():
    """x = 1 and dy = 1 everywhere: each 3^3 tap's sum is the number of
    voxels whose neighbour along the tap is inside the volume."""
    d, h, w = 4, 5, 6
    got = conv3d_wgrad_plain(torch.ones((2, 1, d, h, w)), torch.ones((2, 1, d, h, w)), 3)[0, 0]
    inside = [torch.tensor([n - abs(k - 1) for k in range(3)], dtype=torch.float32)
              for n in (d, h, w)]
    want = 2 * inside[0][:, None, None] * inside[1][None, :, None] * inside[2][None, None, :]
    assert torch.equal(got, want)


# float32: the weight gradient sums in another order than oneDNN's, so 1e-5
# of sum |x dy|; the bias is the same dense sum, 1e-6 of sum |dy|; the input
# gradient is the same call autograd makes, 1e-6.  bfloat16, against float32
# autograd of the same bfloat16 values: the weight and bias gradients are
# float32 sums rounded once to bfloat16, so 2^-8 of the value (one ulp)
# besides; the input gradient is oneDNN's bfloat16 convolution on both
# sides, 2^-7 of sum |w dy|.
TOLERANCE = {torch.float32: (1e-5, 0.0, 1e-6), torch.bfloat16: (1e-5, 2.0 ** -8, 2.0 ** -7)}


@pytest.mark.parametrize("side", [1, 3])
@pytest.mark.parametrize("input_grad", [False, True], ids=["weights", "weights_and_input"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_function_matches_autograd_of_conv3d(dtype, input_grad, side):
    rel, ulp, dx_rel = TOLERANCE[dtype]
    pad = (side - 1) // 2
    x0, dy = _pair(2, 16, 32, (6, 7, 5), seed=side, dtype=dtype)
    gen = torch.Generator().manual_seed(5)
    w0 = (torch.randn((32, 16, side, side, side), generator=gen) * 0.05).to(dtype)
    b0 = (torch.randn(32, generator=gen) * 0.05).to(dtype)

    def grads(fn, cast):
        x = x0.to(cast).clone().requires_grad_(input_grad)
        w = w0.to(cast).clone().requires_grad_(True)
        b = b0.to(cast).clone().requires_grad_(True)
        y = fn(x, w, b)
        y.backward(dy.to(cast))
        return y, x.grad, w.grad, b.grad

    y, dx, dw, db = grads(conv3d, dtype)
    conv = lambda x, w, b: F.conv3d(x, w, b, padding=pad)  # noqa: E731
    _, dx_ref, dw_ref, db_ref = grads(conv, torch.float32)
    assert torch.equal(y, F.conv3d(x0, w0, b0, padding=pad))  # the forward is F.conv3d's
    assert dw.dtype == db.dtype == dtype and dw.shape == w0.shape
    scale = _scale(x0, dy, side).float()
    assert torch.all((dw.float() - dw_ref).abs() <= rel * scale + ulp * dw_ref.abs())
    db_scale = dy.float().abs().sum(dim=(0, 2, 3, 4))
    assert torch.all((db.float() - db_ref).abs() <= 1e-6 * db_scale + ulp * db_ref.abs())
    if not input_grad:
        assert dx is None
        return
    if dtype == torch.bfloat16:  # the same bfloat16 convolution autograd would run
        dx_ref = grads(conv, dtype)[1]
    dx_scale = torch.nn.grad.conv3d_input(x0.shape, w0.double().abs(), dy.double().abs(),
                                          padding=pad).float()
    assert dx.dtype == dtype
    assert torch.all((dx.float() - dx_ref.float()).abs() <= dx_rel * dx_scale)


TAKES = {
    "3^3 32 to 32": (nn.Conv3d(32, 32, 3, padding=1), True),
    "3^3 16 to 32": (nn.Conv3d(16, 32, 3, padding=1), True),
    "1^3 32 to 14": (nn.Conv3d(32, 14, 1), True),
    "one channel": (nn.Conv3d(1, 3, 3, padding=1), True),
    "64 out": (nn.Conv3d(32, 64, 3, padding=1), False),
    "33 in": (nn.Conv3d(33, 32, 1), False),
    "the stem's 7^3": (nn.Conv3d(1, 16, 7, padding=3), False),
    "5^3": (nn.Conv3d(16, 16, 5, padding=2), False),
    "no padding": (nn.Conv3d(16, 16, 3), False),
    "stride 2": (nn.Conv3d(16, 16, 3, stride=2, padding=1), False),
    "dilation 2": (nn.Conv3d(16, 16, 3, padding=2, dilation=2), False),
    "groups 2": (nn.Conv3d(16, 16, 3, padding=1, groups=2), False),
    "reflect padding": (nn.Conv3d(16, 16, 3, padding=1, padding_mode="reflect"), False),
    "1x3x3": (nn.Conv3d(16, 16, (1, 3, 3), padding=(0, 1, 1)), False),
    "transposed": (nn.ConvTranspose3d(16, 16, 1), False),
    "2-D": (nn.Conv2d(16, 16, 3, padding=1), False),
}


@pytest.mark.parametrize("kind", list(TAKES))
def test_takes_is_the_shape_rule(kind):
    conv, want = TAKES[kind]
    assert hopper_conv3d.takes(conv) is want


def test_v2v_routes_exactly_its_fourteen_dense_layers(monkeypatch):
    """At G = 16 ``takes`` picks the fourteen convolutions at 8^3 and no
    other; a backward computes their weight gradients through the module
    (counted by a stub of the plain version), each on an 8^3 volume, and the
    parameter names are those of nn.Conv3d."""
    net = V2VPoseNet(V2VConfig(grid=16, cube_voxels=24),
                     generator=torch.Generator().manual_seed(0))
    picked = [name for name, mod in net.named_modules() if hopper_conv3d.takes(mod)]
    assert picked == DENSE
    convs = [name for name, mod in net.named_modules()
             if isinstance(mod, (nn.Conv3d, nn.ConvTranspose3d))]
    assert len(convs) == 31 and "stem.conv" in convs and "up1.conv" in convs
    calls = []
    plain = hopper_conv3d.conv3d_wgrad_plain

    def counted(x, dy, side):
        calls.append((x.shape[1], dy.shape[1], side, tuple(x.shape[2:])))
        return plain(x, dy, side)

    monkeypatch.setattr(hopper_conv3d, "conv3d_wgrad_plain", counted)
    x = (torch.rand((2, 1, 16, 16, 16), generator=torch.Generator().manual_seed(1)) < 0.05)
    net(x.float()).square().sum().backward()
    assert len(calls) == 14
    assert all(volume == (8, 8, 8) for *_, volume in calls)
    assert sorted(side for _, _, side, _ in calls) == [1] * 4 + [3] * 10
    mods = dict(net.named_modules())
    assert sorted(c[:3] for c in calls) == sorted(
        (mods[n].in_channels, mods[n].out_channels, mods[n].kernel_size[0]) for n in DENSE)
    for name in DENSE:
        assert mods[name].weight.grad is not None and mods[name].bias.grad is not None


def _fake_cuda(cin=16, cout=32, volume=(8, 8, 8)):
    x = torch.empty((2, cin, *volume), device="cuda")
    dy = torch.empty((2, cout, *volume), device="cuda")
    return x, dy


def test_weight_grad_routes_by_device(monkeypatch):
    """A CPU tensor takes the plain version and never the kernel; a CUDA
    tensor (faked) takes the kernel once a backward, and never the plain
    version.  (The CUDA backward is called directly: autograd's engine
    would start a device thread for the fake card.)"""
    launched, plain_calls = [], []
    plain = hopper_conv3d.conv3d_wgrad_plain

    def fake_launch(args):
        launched.append(args)
        return args.out

    monkeypatch.setattr(hopper_conv3d, "launch_conv3d_wgrad", fake_launch)
    monkeypatch.setattr(hopper_conv3d, "conv3d_wgrad_plain",
                        lambda *a: plain_calls.append(1) or plain(*a))
    x, _ = _pair(2, 16, 32, (4, 4, 4), seed=1, dtype=torch.float32)
    w = torch.zeros((32, 16, 3, 3, 3), requires_grad=True)
    b = torch.zeros(32, requires_grad=True)
    conv3d(x, w, b).sum().backward()
    assert plain_calls == [1] and launched == []
    plain_calls.clear()
    with FakeTensorMode(allow_non_fake_inputs=True):
        xc, dy = _fake_cuda()
        wc = torch.empty((32, 16, 3, 3, 3), device="cuda")
        ctx = SimpleNamespace(saved_tensors=(xc, wc), needs_input_grad=(False, True, True))
        dx, dw, db = hopper_conv3d.Conv3dSame.backward(ctx, dy)
        assert dx is None and dw.device.type == "cuda" and dw.shape == (32, 16, 3, 3, 3)
        assert db.shape == (32,)
    assert plain_calls == [] and len(launched) == 1
    (args,) = launched
    assert args.x.shape == (2, 16, 8, 8, 8) and args.dy.shape == (2, 32, 8, 8, 8)
    assert args.partial.shape == (hopper_conv3d.BLOCKS[3], 32 * 16 * 27)
    assert args.partial.dtype == torch.float32 and args.out.shape == (32, 16, 3, 3, 3)


def test_a_cuda_tensor_without_the_kernel_raises(monkeypatch):
    """Where the kernel cannot be built the weight gradient of a CUDA tensor
    raises the build's error: the plain version is never taken, and the
    launch counter does not move."""

    def missing(source):
        raise RuntimeError("nvcc not found (looked on PATH)")

    monkeypatch.setattr(_build, "load_library", missing)
    monkeypatch.setattr(hopper_conv3d, "conv3d_wgrad_plain",
                        lambda *a: pytest.fail("fell back to the plain version"))
    hopper_conv3d.build.cache_clear()
    before = hopper_conv3d.LAUNCHES["conv3d_wgrad"]
    try:
        with FakeTensorMode(allow_non_fake_inputs=True), warnings.catch_warnings():
            warnings.simplefilter("ignore")  # a fake tensor's data pointer
            x, dy = _fake_cuda()
            with pytest.raises(RuntimeError, match="nvcc not found"):
                hopper_conv3d.conv3d_weight_grad(x, dy, 3)
    finally:
        hopper_conv3d.build.cache_clear()
    assert hopper_conv3d.LAUNCHES["conv3d_wgrad"] == before


def test_launch_counts_one_call_and_passes_the_c_order(monkeypatch):
    """One weight gradient is one count of ``LAUNCHES``; the library gets
    the sizes in the order of its C signature (a stub library records
    them)."""
    seen = []
    stub = _StubLib(dp_conv3d_wgrad=lambda *a: seen.append(a) or 0)
    monkeypatch.setattr(_build, "load_library", lambda source: stub)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: SimpleNamespace(cuda_stream=1234))
    hopper_conv3d.build.cache_clear()
    before = hopper_conv3d.LAUNCHES["conv3d_wgrad"]
    try:
        with FakeTensorMode(allow_non_fake_inputs=True), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            x, dy = _fake_cuda(32, 14, (5, 6, 7))
            out = hopper_conv3d.conv3d_weight_grad(x, dy, 1)
            assert out.shape == (14, 32, 1, 1, 1)
    finally:
        hopper_conv3d.build.cache_clear()
    assert hopper_conv3d.LAUNCHES["conv3d_wgrad"] == before + 1
    (args,) = seen
    # elem_bytes, blocks, row, n, cin, cout, k, d, h, w, then the stream
    assert args[4:] == (4, hopper_conv3d.BLOCKS[1], 32 * 32, 2, 32, 14, 1, 5, 6, 7, 1234)


def test_conv3d_wgrad_build_binds_the_c_signature(monkeypatch):
    """``dp_conv3d_wgrad``: the four buffers and the stream as c_void_p, the
    element width, the grid of blocks, the scratch row and the sizes as
    c_int, in the order csrc/conv3d_wgrad.cu declares them."""
    monkeypatch.setattr(_build, "load_library", lambda source: _StubLib())
    hopper_conv3d.build.cache_clear()
    try:
        lib = hopper_conv3d.build()
        want = _c_signature("dp_conv3d_wgrad", "conv3d_wgrad.cu")
        assert list(lib.dp_conv3d_wgrad.argtypes) == want
        assert want == [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        assert lib.dp_conv3d_wgrad.restype is ctypes.c_int
        assert lib.dp_error_string.restype is ctypes.c_char_p
        assert hopper_conv3d.build.pointers["dp_conv3d_wgrad"] == (0, 1, 2, 3)
    finally:
        hopper_conv3d.build.cache_clear()


def _refusal(kind):
    """(callable, exception, message) of one refusal."""
    x = torch.zeros((2, 16, 4, 5, 6))
    dy = torch.zeros((2, 32, 4, 5, 6))
    args = hopper_conv3d.conv3d_wgrad_args(x, dy, 3)
    launch = hopper_conv3d.launch_conv3d_wgrad
    return {
        "float64": (lambda: hopper_conv3d.conv3d_wgrad_args(x.double(), dy.double(), 3),
                    TypeError, "float32"),
        "mixed dtypes": (lambda: hopper_conv3d.conv3d_wgrad_args(x, dy.bfloat16(), 3),
                         TypeError, "float32"),
        "a 5^3 window": (lambda: hopper_conv3d.conv3d_wgrad_args(x, dy, 5), ValueError, "side"),
        "33 input channels": (lambda: hopper_conv3d.conv3d_wgrad_args(
            torch.zeros((2, 33, 4, 5, 6)), dy, 3), ValueError, "channels"),
        "64 output channels": (lambda: hopper_conv3d.conv3d_wgrad_args(
            x, torch.zeros((2, 64, 4, 5, 6)), 1), ValueError, "channels"),
        "another volume": (lambda: hopper_conv3d.conv3d_wgrad_args(
            x, torch.zeros((2, 32, 4, 5, 7)), 3), ValueError, "volume"),
        "another batch": (lambda: hopper_conv3d.conv3d_wgrad_args(
            x, torch.zeros((1, 32, 4, 5, 6)), 3), ValueError, "batch"),
        "a 4-D input": (lambda: conv3d_wgrad_plain(x[0], dy[0], 3), ValueError, "N, C"),
        "an empty volume": (lambda: hopper_conv3d.conv3d_wgrad_args(
            torch.zeros((2, 16, 0, 5, 6)), torch.zeros((2, 32, 0, 5, 6)), 3),
            ValueError, "empty"),
        "a scratch of another row": (lambda: launch(
            args._replace(partial=torch.empty((3, 100)))), ValueError, "scratch"),
        "an output of another shape": (lambda: launch(
            args._replace(out=torch.empty((32, 16, 1, 1, 1)))), ValueError, "out"),
        "a float64 output": (lambda: launch(args._replace(out=args.out.double())),
                             TypeError, "one dtype"),
        "non-contiguous x": (lambda: launch(args._replace(
            x=torch.zeros((2, 4, 5, 6, 16)).permute(0, 4, 1, 2, 3))), ValueError, "contiguous"),
        "non-contiguous dy": (lambda: launch(args._replace(
            dy=torch.zeros((2, 4, 5, 6, 32)).permute(0, 4, 1, 2, 3))), ValueError, "contiguous"),
        "CPU tensors": (lambda: launch(args), ValueError, "CUDA"),
        "a 5^3 weight": (lambda: conv3d(x, torch.zeros((32, 16, 5, 5, 5)), torch.zeros(32)),
                         ValueError, "weight"),
        "a 64-channel weight": (lambda: conv3d(x, torch.zeros((64, 16, 3, 3, 3)),
                                               torch.zeros(64)), ValueError, "weight"),
    }[kind]


REFUSALS = ["float64", "mixed dtypes", "a 5^3 window", "33 input channels",
            "64 output channels", "another volume", "another batch", "a 4-D input",
            "an empty volume", "a scratch of another row", "an output of another shape",
            "a float64 output", "non-contiguous x", "non-contiguous dy", "CPU tensors",
            "a 5^3 weight", "a 64-channel weight"]


@pytest.mark.parametrize("kind", REFUSALS)
def test_arguments_refuse_what_the_kernel_does_not_take(kind):
    fn, exc, match = _refusal(kind)
    with pytest.raises(exc, match=match):
        fn()


def test_scratch_row_pads_input_channels_to_16_or_32_and_output_channels_to_32():
    assert hopper_conv3d.partial_row(16, 3) == 32 * 16 * 27
    assert hopper_conv3d.partial_row(14, 3) == 32 * 16 * 27
    assert hopper_conv3d.partial_row(32, 1) == 32 * 32
    assert hopper_conv3d.partial_row(17, 1) == 32 * 32
    args = hopper_conv3d.conv3d_wgrad_args(torch.zeros((1, 14, 3, 3, 3), dtype=torch.bfloat16),
                                           torch.zeros((1, 3, 3, 3, 3), dtype=torch.bfloat16), 1)
    assert args.partial.shape == (hopper_conv3d.BLOCKS[1], 32 * 16)
    assert args.partial.dtype == torch.float32 and args.out.dtype == torch.bfloat16
