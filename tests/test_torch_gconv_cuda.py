"""PyTorch port, the grouped 3x3 convolution kernel (``csrc/gconv.cu``, via
``dcnn/cuda_gconv.py``) against ``F.conv2d`` on the card.

The kernel sums each output's 9 x C_in_g products in one fixed order; cuDNN
may take another at other shapes (at X101's it takes the same one and the
two agree bit for bit), so each case holds them to the float32 error bound
of such a sum (see :func:`assert_within_bound`).
These tests need an NVIDIA GPU (sm_90a) and nvcc, and skip without one.  The
file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_gconv_cuda.py -q
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from apse_uav_torch.dcnn import config as pconfig, cuda_gconv
from apse_uav_torch.dcnn.engines import TrackPredictor
from apse_uav_torch.dcnn.models.resnet import GroupedConvNorm, conv
from apse_uav_torch.utils import profiling

pytestmark = pytest.mark.cuda

GROUPS = 32
# X101-32x8d's distinct grouped 3x3s at the benchmark's 768x1344 padded
# input: (channels a group, stride, H_in, W_in); res2, res3 (stride 2, then
# 1), res4, res5.
X101_CASES = [(8, 1, 192, 336), (16, 2, 192, 336), (16, 1, 96, 168), (32, 2, 96, 168), (32, 1, 48, 84),
              (64, 2, 48, 84), (64, 1, 24, 42)]
# Heights and widths that are no multiple of a tile: every instance's ragged
# edges, with odd widths (the halo loads float by float) and with widths a
# multiple of 4 (float4 loads, the last one cut short).
RAGGED_CASES = [(8, 1, 37, 61), (8, 2, 37, 61), (16, 1, 19, 45), (16, 2, 35, 67), (32, 1, 13, 29), (32, 2, 23, 41),
                (64, 1, 7, 11), (64, 2, 9, 13), (8, 1, 37, 60), (8, 2, 21, 36), (16, 1, 19, 44), (16, 2, 35, 68),
                (32, 1, 13, 36), (32, 2, 23, 44), (64, 1, 7, 12), (64, 2, 9, 20)]
# The error bound's constant: each side's float32 sum of K products lies within
# K * 2**-24 * sum|x||w| of the exact sum (one rounding a term, whatever the
# order), so the two sides within twice that of each other.
C_BOUND = 2.0


def case_id(case) -> str:
    return "w{}s{}_{}x{}".format(*case)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def full_fp32():
    """cuDNN's float32 convolutions in full float32 (TF32 off), as the tracker runs them."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32 = saved


def make(width: int, h: int, w: int, n: int, dev, seed: int):
    """A seeded input map and weights of 32 groups of ``width`` channels
    (He-scaled, so outputs stay O(1))."""
    g = torch.Generator().manual_seed(seed)
    c = GROUPS * width
    x = torch.randn(n, c, h, w, generator=g).to(dev)
    weight = (torch.randn(c, width, 3, 3, generator=g) * (2.0 / (9 * width)) ** 0.5).to(dev)
    return x, weight


def assert_within_bound(y, x, weight, stride):
    """|kernel - F.conv2d| <= C_BOUND * K * 2**-24 * conv2d(|x|, |w|) at
    every output, K = 9 * C_in_g: the float32 error bound of a sum of K
    products, for each side, whatever order it sums in (the magnitude in
    float64)."""
    want = F.conv2d(x, weight, None, stride, 1, 1, GROUPS)
    mag = F.conv2d(x.abs().double(), weight.abs().double(), None, stride, 1, 1, GROUPS)
    assert y.shape == want.shape and y.dtype == torch.float32
    k = 9 * weight.shape[1]
    gap = (y.double() - want.double()).abs()
    assert bool((gap <= C_BOUND * k * 2.0 ** -24 * mag).all()), float((gap / mag.clamp_min(1e-30)).max())


@pytest.mark.parametrize("case", X101_CASES, ids=case_id)
def test_x101_shapes_within_bound(dev, case):
    """The 7 distinct X101 convolutions at batch 4, each within its bound of
    ``F.conv2d`` (TF32 off)."""
    width, stride, h, w = case
    x, weight = make(width, h, w, 4, dev, seed=width * 10 + stride)
    assert_within_bound(cuda_gconv.conv(x, weight, stride, GROUPS), x, weight, stride)


@pytest.mark.parametrize("case", RAGGED_CASES, ids=case_id)
def test_ragged_shapes_within_bound(dev, case):
    """Batch 1 at heights and widths that are no multiple of a tile: the
    halo's zero padding and the masked edge tiles of every instance."""
    width, stride, h, w = case
    x, weight = make(width, h, w, 1, dev, seed=h * w)
    assert_within_bound(cuda_gconv.conv(x, weight, stride, GROUPS), x, weight, stride)


@pytest.mark.parametrize("case", [X101_CASES[0], X101_CASES[4], RAGGED_CASES[7]], ids=case_id)
def test_two_runs_same_bits(dev, case):
    """One fixed summation order, no split of the reduction and no atomics:
    two runs on the same input give the same bits."""
    width, stride, h, w = case
    x, weight = make(width, h, w, 2, dev, seed=7)
    assert torch.equal(cuda_gconv.conv(x, weight, stride, GROUPS), cuda_gconv.conv(x, weight, stride, GROUPS))


@pytest.mark.parametrize("case", [X101_CASES[0], X101_CASES[3], X101_CASES[4]], ids=case_id)
def test_unaligned_map_same_bits(dev, case):
    """A map whose storage starts 4 bytes past a 16-byte boundary takes the
    float-by-float halo loads; the sums are the same, so are the bits."""
    width, stride, h, w = case
    x, weight = make(width, h, w, 1, dev, seed=11)
    flat = torch.empty(x.numel() + 1, device=dev)
    shifted = flat[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    assert torch.equal(cuda_gconv.conv(shifted, weight, stride, GROUPS), cuda_gconv.conv(x, weight, stride, GROUPS))


def test_one_launch_a_call(dev):
    x, weight = make(32, 48, 84, 4, dev, seed=1)
    profiling.reset_counters()
    cuda_gconv.conv(x, weight, 1, GROUPS)
    assert profiling.counters == {"launch." + cuda_gconv.NAME: 1}


def test_x101_forward_launches_33(dev):
    """A TrackPredictor forward of X101-32x8d: one launch a grouped 3x3, 33,
    as many as its ``track.gconv`` spans."""
    pred = TrackPredictor(pconfig.mask_rcnn_x101_32x8d_fpn(4), None, (256, 448), device=dev)
    frames = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (1, 256, 448, 3), dtype=np.uint8)).to(dev)
    profiling.reset_counters()
    profiling.reset_spans()
    profiling.enable_spans(True)
    try:
        pred(frames)
        torch.cuda.synchronize()
    finally:
        profiling.enable_spans(False)
    spans = [s for s in profiling.spans() if s.name == "track.gconv"]
    profiling.reset_spans()
    assert profiling.counters["launch." + cuda_gconv.NAME] == len(spans) == 33


def test_module_takes_the_kernel_only_without_grad(dev):
    """``GroupedConvNorm`` on the card: without a gradient to record, the
    kernel then its frozen BN (bit for bit); under autograd ``F.conv2d``,
    no launch, and gradients reach the input and the weights."""
    m = GroupedConvNorm(GROUPS * 16, GROUPS * 16, 3, 2, GROUPS).to(dev)
    x, weight = make(16, 35, 67, 2, dev, seed=3)
    with torch.no_grad():
        m.weight.copy_(weight)
        profiling.reset_counters()
        got = m(x)
        assert profiling.counters["launch." + cuda_gconv.NAME] == 1
        assert torch.equal(got, m.norm(cuda_gconv.conv(x, m.weight, m.stride, GROUPS)))
    profiling.reset_counters()
    xg = x.clone().requires_grad_(True)
    y = m(xg)
    assert "launch." + cuda_gconv.NAME not in profiling.counters
    assert torch.equal(y, m.norm(conv(m, xg)))
    y.square().sum().backward()
    assert xg.grad is not None and m.weight.grad is not None
    assert bool(torch.isfinite(m.weight.grad).all()) and float(m.weight.grad.abs().sum()) > 0


@pytest.mark.parametrize("fault", ["non_contiguous", "bfloat16", "kernel_5x5", "width_4", "cpu_weight"])
def test_wrapper_raises(dev, fault):
    """The wrapper refuses, before any launch, what the kernel does not take."""
    x, weight = make(8, 20, 24, 1, dev, seed=5)
    stride, groups = 1, GROUPS
    if fault == "non_contiguous":
        x = x.transpose(2, 3)
    elif fault == "bfloat16":
        x, weight = x.bfloat16(), weight.bfloat16()
    elif fault == "kernel_5x5":
        weight = torch.zeros(weight.shape[0], 8, 5, 5, device=dev)
    elif fault == "width_4":
        groups = 64
        weight = weight.reshape(GROUPS * 8, 8, 3, 3)[:, :4].contiguous()
    else:
        weight = weight.cpu()
    profiling.reset_counters()
    with pytest.raises(ValueError):
        cuda_gconv.conv(x, weight, stride, groups)
    assert profiling.counters == {}
