"""CPU self-tests of ``k10_roofline_pct.train`` and of the count it reads,
``models/v2v_wgrad_flops.py``: the count of K10's operations on the
reference network, the share on a hand-built record, and None where the
program launched no ``conv3d_wgrad`` kernel, as the parent does.

    python -m pytest bench_torch/tests -q
"""

import time
from types import SimpleNamespace

import pytest
import torch

from bench_torch.lib import spec
from bench_torch.lib.harness import Record
from bench_torch.models import v2v_wgrad_flops
from bench_torch.models.peaks import H100_SXM
from deepprior_tpu_torch.utils import profiling

MS = 1_000_000
NAME = "k10_roofline_pct.train"
KERNELS = ("void (anonymous namespace)::conv3d_wgrad_partial<3, 32, 32, float>(...)",
           "void (anonymous namespace)::conv3d_wgrad_reduce<3, 32, 32, float>(...)")


def test_count_is_the_fourteen_layers_at_44():
    """At B = 8 and the published 88^3 grid: ten 3^3 layers (one 16 -> 32,
    nine 32 -> 32) and four 1^3 (16 -> 32, two 32 -> 32, 32 -> 14) at 44^3,
    2 x N x D x H x W x Cin x Cout x k^3 each: 362.1 GFLOP."""
    voxels = 8 * 44 ** 3
    want = 2 * voxels * (16 * 32 * 27 + 9 * 32 * 32 * 27 + 16 * 32 + 2 * 32 * 32 + 32 * 14)
    assert v2v_wgrad_flops.wgrad_flops(8) == want == 362_085_154_816
    assert v2v_wgrad_flops.wgrad_flops(1, 24, 21) == 2 * 12 ** 3 * (
        16 * 32 * 27 + 9 * 32 * 32 * 27 + 16 * 32 + 2 * 32 * 32 + 32 * 21)


def test_layout_is_the_networks():
    """The reference layout the count runs on has the program's parameter
    names and shapes (a guard on the hand-written widths; the count itself
    never reads the program)."""
    from deepprior_tpu_torch.models import V2VPoseNet

    with torch.device("meta"):
        program = V2VPoseNet().state_dict()
    layout = v2v_wgrad_flops.layout(14)
    assert sorted(layout) == sorted(program)
    assert all(layout[k] == program[k].shape for k in program)


@pytest.mark.parametrize("kind, want", [
    ("a 3^3 32 -> 32 layer", True), ("the stem", False), ("stride 2", False),
    ("64 channels", False), ("transposed", False), ("1^3 unpadded", True),
    ("3^3 unpadded", False)])
def test_count_rule(kind, want):
    args = {"a 3^3 32 -> 32 layer": ((8, 32, 44, 44, 44), (32, 32, 3, 3, 3), [1] * 3, [1] * 3),
            "the stem": ((8, 1, 88, 88, 88), (16, 1, 7, 7, 7), [1] * 3, [3] * 3),
            "stride 2": ((8, 32, 44, 44, 44), (32, 32, 3, 3, 3), [2] * 3, [1] * 3),
            "64 channels": ((8, 32, 22, 22, 22), (64, 32, 3, 3, 3), [1] * 3, [1] * 3),
            "transposed": ((8, 64, 22, 22, 22), (64, 32, 2, 2, 2), [2] * 3, [0] * 3),
            "1^3 unpadded": ((8, 32, 44, 44, 44), (14, 32, 1, 1, 1), [1] * 3, [0] * 3),
            "3^3 unpadded": ((8, 32, 44, 44, 44), (32, 32, 3, 3, 3), [1] * 3, [0] * 3)}[kind]
    x, w, stride, padding = args
    assert v2v_wgrad_flops.takes(x, w, stride, padding, [1] * 3, kind == "transposed", 1) is want


def _record(ops, steps=4, batch=8, grid=88, joints=14, peak=H100_SXM):
    """A traced window of 100 ms holding ``steps`` step spans (and one after
    it), the program's ``train.voxelize`` spans, and the device ``ops``."""
    t0 = time.perf_counter_ns()
    profiling.clear()
    with profiling.recording():
        for i in range(steps + 1):
            profiling.record("train.voxelize", t0 + (20 * i + 1) * MS, t0 + (20 * i + 2) * MS,
                             id=i, batch=batch, grid=grid, joints=joints)
    spans = {"step": [((t0 + 20 * i * MS) / 1e9, (t0 + (20 * i + 19) * MS) / 1e9)
                      for i in range(steps)] + [((t0 + 150 * MS) / 1e9, (t0 + 160 * MS) / 1e9)]}
    tracer = SimpleNamespace(perf_window=(t0 / 1e9, (t0 + 100 * MS) / 1e9), spans=spans)
    return Record({"batch": batch}, tracer, {"ops": ops}, peak)


def test_share_of_the_roofline_on_a_synthetic_trace():
    """Four steps in the window, K10's two kernels 14 ms of device time a
    step: 362.1 GFLOP / 67 TFLOP/s = 5.404 ms over 14 ms."""
    secs = 4 * 0.014
    ops = {KERNELS[0]: (4 * 14, 0.9 * secs), KERNELS[1]: (4 * 14, 0.1 * secs),
           "sm80_xmma_dgrad_implicit_gemm": (40, 1.0)}
    try:
        got = spec.metric_reader(NAME).read(_record(ops))
    finally:
        profiling.clear()
    assert got == pytest.approx(100 * 362_085_154_816 / 67e12 / 0.014)


def test_none_without_the_kernel_or_the_steps():
    """The parent launches no ``conv3d_wgrad`` kernel: none.  No peak, no
    step or no ``train.voxelize`` span in the window: none."""
    reader = spec.metric_reader(NAME)
    try:
        assert reader.read(_record({"wgrad2d_grouped_direct_kernel": (56, 1.2)})) is None
        assert reader.read(_record({KERNELS[0]: (56, 0.05)}, peak=None)) is None
        assert reader.read(_record({KERNELS[0]: (56, 0.05)}, steps=0)) is None
        rec = _record({KERNELS[0]: (56, 0.05)})
        profiling.clear()
        assert reader.read(rec) is None
        assert reader.read(Record({}, SimpleNamespace(), {}, None)) is None
    finally:
        profiling.clear()
