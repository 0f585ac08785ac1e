"""The yardstick's counts against PERF.md's hand counts and against
`torch.utils.flop_counter` on one gate convolution."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import roofline


@pytest.mark.parametrize("kind,bytes_per_voxel", [("fit", 72), ("cycle", 120),
                                                  ("synth", 72)])
def test_ideal_bytes_per_voxel(kind, bytes_per_voxel):
    # the bound columns of the kernel table: 72, 120 and 72 B a voxel at 6
    # echoes
    assert roofline.IDEAL_BYTES_PER_VOXEL[kind](6) == bytes_per_voxel
    assert roofline.ideal_bytes(kind, 8, 384, 384, 6) == \
        bytes_per_voxel * 8 * 384 * 384


@pytest.mark.parametrize("f,tflop", [(36, 0.587), (72, 2.275)])
def test_convlstm_forward_flops(f, tflop):
    # 587 GFLOP (F=36) and 2.275 TFLOP (F=72) at nb=8, 384^2, Cin=2, ne=6
    got = roofline.convlstm_flops(8, 384, 384, 2, f, 6) / 1e12
    assert abs(got - tflop) < 5e-4


def test_one_gate_convolution_by_hand_and_by_counter():
    nb, h, cin, f = 8, 384, 2, 36
    with torch.device("meta"):
        x = torch.zeros(nb, cin + f, h, h)
        w = torch.zeros(4 * f, cin + f, 3, 3)
        with FlopCounterMode(display=False) as counter:
            torch.nn.functional.conv2d(x, w, padding=1)
    hand = 2 * nb * h * h * 9 * (cin + f) * 4 * f
    assert counter.get_total_flops() == hand
    # the forward's count is ne such convolutions less echo 0's recurrent
    # term
    ne = 6
    assert roofline.convlstm_flops(nb, h, h, cin, f, ne) == \
        ne * hand - 2 * nb * h * h * 9 * f * 4 * f


def test_backward_adds_the_kernel_and_recurrent_gradients():
    fwd = roofline.convlstm_flops(8, 384, 384, 2, 36, 6)
    bwd = roofline.convlstm_flops(8, 384, 384, 2, 36, 6, backward=True)
    rec = 2.0 * 8 * 384 * 384 * 9 * 4 * 36 * 36 * 5
    assert bwd == pytest.approx(2 * fwd + rec)


def test_bound_is_the_larger_of_flops_and_bytes():
    calls = [(8, 384, 384, 2, 36, 6, False)]
    peak = roofline.peak_flops({"cudnn_tf32": True})
    b = roofline.convlstm_bound_s(calls, peak)
    assert b == pytest.approx(roofline.convlstm_flops(*calls[0]) / 495e12)
    assert roofline.peak_flops({"cudnn_tf32": False}) == peak / 3
    assert roofline.ideal_bound_s([("fit", 8, 384, 384, 6)]) == \
        pytest.approx(72 * 8 * 384 * 384 / 3.35e12)


def test_trace_union_and_gaps():
    from port_bench.trace import Trace
    tr = Trace(kernels=[("convlstm_echo_mma", 0, 10), ("fit_kernel", 5, 20),
                        ("Memcpy DtoH", 40, 50)],
               window=(0, 100),
               host_ops=[("aten::copy_", 18, 45), ("aten::cat", 55, 60)],
               units=2)
    assert tr.busy_s == 30e-6
    assert tr.seconds_by("convlstm") == 10e-6
    assert tr.seconds_by("ideal") == 15e-6
    assert tr.seconds_by("copies") == 10e-6
    gaps = tr.idle_gaps()
    assert gaps[0] == ["after aten::cat", 50e-6]
    assert gaps[1] == ["aten::copy_", 20e-6]
