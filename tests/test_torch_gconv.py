"""PyTorch port, the grouped 3x3 convolution's dispatch on the CPU: which
convolutions the hand-written kernel (``csrc/gconv.cu``) takes, and that
``GroupedConvNorm`` keeps ``F.conv2d`` wherever the kernel does not run
(the CPU, autograd).  The kernel itself runs only on the card
(``tests/test_torch_gconv_cuda.py``).
"""

import os

import pytest
import torch

from apse_uav_torch import _build
from apse_uav_torch.dcnn import config as pconfig, cuda_gconv
from apse_uav_torch.dcnn.models.c4 import build_model
from apse_uav_torch.dcnn.models.resnet import GroupedConvNorm, conv

INSTANCES = [(w, s) for w in cuda_gconv.WIDTHS for s in cuda_gconv.STRIDES]


@pytest.fixture
def no_kernel(monkeypatch):
    """Fail the test if anything calls the kernel's wrapper."""
    def refuse(*args, **kwargs):
        raise AssertionError("the CUDA kernel was called")
    monkeypatch.setattr(cuda_gconv, "conv", refuse)


def test_every_x101_grouped_conv_is_taken():
    """All 33 of X101-32x8d's grouped 3x3s are shapes the kernel takes."""
    with torch.device("meta"):
        model = build_model(pconfig.mask_rcnn_x101_32x8d_fpn(4))
    grouped = [m for m in model.modules() if isinstance(m, GroupedConvNorm)]
    taken = [m for m in grouped if cuda_gconv.supports(m.in_channels, m.out_channels, m.groups, m.kernel_size,
                                                        m.stride, m.padding, m.dilation)]
    assert len(grouped) == len(taken) == 33
    assert {(m.in_channels // m.groups, m.stride[0]) for m in taken} == {(8, 1), (16, 1), (16, 2), (32, 1), (32, 2),
                                                                         (64, 1), (64, 2)}


@pytest.mark.parametrize("fields", [
    dict(kernel_size=5), dict(padding=0), dict(dilation=2), dict(groups=64), dict(in_channels=4096, out_channels=4096),
    dict(stride=3), dict(stride=(1, 2)), dict(out_channels=512),
], ids=["5x5", "padding0", "dilation2", "width4", "width128", "stride3", "stride1x2", "out_ne_in"])
def test_supports_refuses(fields):
    base = dict(in_channels=256, out_channels=256, groups=32, kernel_size=3, stride=1, padding=1, dilation=1)
    assert cuda_gconv.supports(**base)
    assert not cuda_gconv.supports(**{**base, **fields})


@pytest.mark.parametrize("width,stride", INSTANCES)
def test_cpu_output_is_conv_then_norm(width, stride, no_kernel):
    """On the CPU ``GroupedConvNorm`` is ``conv(self, x)`` then its frozen BN,
    bit for bit, at every width and stride the kernel has an instance for."""
    g = torch.Generator().manual_seed(width + stride)
    c = 32 * width
    m = GroupedConvNorm(c, c, 3, stride, 32)
    with torch.no_grad():
        m.weight.normal_(generator=g)
        m.norm.running_var.uniform_(0.5, 2.0, generator=g)
        m.norm.bias.normal_(generator=g)
        x = torch.randn(1, c, 9, 11, generator=g)
        assert torch.equal(m(x), m.norm(conv(m, x)))


def test_autograd_stays_on_conv2d(no_kernel):
    """Under autograd the path is ``F.conv2d``: the output and the gradients
    of the input and the weights are those of ``conv(self, x)``."""
    g = torch.Generator().manual_seed(0)
    m = GroupedConvNorm(256, 256, 3, 2, 32)
    with torch.no_grad():
        m.weight.normal_(generator=g)
    x = torch.randn(2, 256, 10, 12, generator=g, requires_grad=True)
    y = m(x)
    y.square().sum().backward()
    got = (y.detach(), x.grad.clone(), m.weight.grad.clone())
    x.grad, m.weight.grad = None, None
    want = m.norm(conv(m, x))
    want.square().sum().backward()
    assert torch.equal(got[0], want.detach()) and torch.equal(got[1], x.grad) and torch.equal(got[2], m.weight.grad)
    assert float(got[2].abs().sum()) > 0


def test_wrapper_takes_only_cuda_tensors():
    """On a CPU tensor the wrapper raises before it builds anything."""
    x, weight = torch.zeros(1, 256, 8, 8), torch.zeros(256, 8, 3, 3)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_gconv.conv(x, weight, 1, 32)


def test_build_lists_gconv():
    assert cuda_gconv.NAME in _build.SOURCES
    assert os.path.exists(os.path.join(_build.CSRC, cuda_gconv.NAME + ".cu"))
