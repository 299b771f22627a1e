"""Colorspace math in PyTorch matching OpenCV 8-bit semantics.

Counterpart of the JAX reference's ``core/colorspace.py``: the reference
preprocessing (RGB2LAB on stored BGR data, gamma 2 LUT on L, LAB2RGB, then
BGR2GRAY) as closed-form float32 math with cv2's u8 quantization points.

Two details keep the plain CPU path, the plain CUDA path and the CUDA kernel
(``csrc/remap.cu``) on the same roundings:

* Division by a constant is an IEEE division on every backend
  (:func:`apse_uav_torch.core.ops.div_const`).
* Rounding is ``torch.round`` (half to even), like ``jnp.round`` and CUDA's
  ``rintf``.

Against XLA on the CPU the chain is not bit-exact everywhere: XLA's f32
``pow``/``cbrt`` are few-ulp approximations and it contracts ``a*b + c`` into
FMAs, so a small fraction of colours land one u8 step apart before the gamma
LUT (pinned in ``tests/test_torch_core.py``).
"""

from __future__ import annotations

import torch

from apse_uav_torch.core.ops import div_const as _div

# D65 whitepoint-normalized RGB->XYZ (OpenCV color_lab.cpp constants).
RGB2XYZ = (
    (0.412453, 0.357580, 0.180423),
    (0.212671, 0.715160, 0.072169),
    (0.019334, 0.119193, 0.950227),
)
# Its float32 inverse exactly as the reference computes it
# (jnp.linalg.inv of the float32 matrix above).
XYZ2RGB = (
    (3.24048113822937, -1.5371514558792114, -0.4985363185405731),
    (-0.9692547917366028, 1.8759899139404297, 0.041555918753147125),
    (0.0556466206908226, -0.20404131710529327, 1.0573110580444336),
)
XN = 0.950456
ZN = 1.088754


def _cbrt(t: torch.Tensor) -> torch.Tensor:
    return torch.sign(t) * torch.pow(torch.abs(t), 1.0 / 3.0)


def _srgb_to_linear(u: torch.Tensor) -> torch.Tensor:
    return torch.where(u <= 0.04045, _div(u, 12.92), torch.pow(_div(u + 0.055, 1.055), 2.4))


def _linear_to_srgb(u: torch.Tensor) -> torch.Tensor:
    u = torch.clamp(u, min=0.0)
    return torch.where(u <= 0.0031308, u * 12.92, 1.055 * torch.pow(u, 1.0 / 2.4) - 0.055)


def _f_cbrt(t: torch.Tensor) -> torch.Tensor:
    return torch.where(t > 0.008856, _cbrt(t), 7.787 * t + 16.0 / 116.0)


def _f_inv(ft: torch.Tensor) -> torch.Tensor:
    return torch.where(ft > 0.2068966, ft * ft * ft, _div(ft - 16.0 / 116.0, 7.787))


def _mix(m, c0, c1, c2):
    return [m[i][0] * c0 + m[i][1] * c1 + m[i][2] * c2 for i in range(3)]


def rgb_to_lab_u8(rgb: torch.Tensor) -> torch.Tensor:
    """COLOR_RGB2LAB on u8 (..., 3) -> u8 (L*255/100, a+128, b+128).

    Applied to the stored channel order, as the reference feeds BGR data
    through COLOR_RGB2LAB."""
    lin = _srgb_to_linear(_div(rgb.to(torch.float32), 255.0))
    x, y, z = _mix(RGB2XYZ, lin[..., 0], lin[..., 1], lin[..., 2])
    fx = _f_cbrt(_div(x, XN))
    fy = _f_cbrt(y)
    fz = _f_cbrt(_div(z, ZN))
    big_l = torch.where(y > 0.008856, 116.0 * fy - 16.0, 903.3 * y)
    lab = torch.stack([big_l * (255.0 / 100.0), 500.0 * (fx - fy) + 128.0, 200.0 * (fy - fz) + 128.0], dim=-1)
    return torch.clamp(torch.round(lab), 0.0, 255.0).to(torch.uint8)


def lab_to_rgb_u8(lab: torch.Tensor) -> torch.Tensor:
    """COLOR_LAB2RGB on u8 (..., 3) -> u8."""
    lab_f = lab.to(torch.float32)
    big_l = lab_f[..., 0] * (100.0 / 255.0)
    a = lab_f[..., 1] - 128.0
    b = lab_f[..., 2] - 128.0
    fy = _div(big_l + 16.0, 116.0)
    fx = fy + _div(a, 500.0)
    fz = fy - _div(b, 200.0)
    x = _f_inv(fx) * XN
    y = torch.where(big_l > 8.0, fy * fy * fy, _div(big_l, 903.3))
    z = _f_inv(fz) * ZN
    lin = torch.stack(_mix(XYZ2RGB, x, y, z), dim=-1)
    return torch.clamp(torch.round(_linear_to_srgb(lin) * 255.0), 0.0, 255.0).to(torch.uint8)


def gamma_l_channel(lab_l: torch.Tensor, gamma: float = 2.0) -> torch.Tensor:
    """The reference's gamma LUT, floor((L/255)^gamma * 255), as closed form."""
    lf = _div(lab_l.to(torch.float32), 255.0)
    return torch.floor(torch.clamp(torch.pow(lf, gamma) * 255.0, 0.0, 255.0)).to(torch.uint8)


def gamma_correct_u8(frame: torch.Tensor, gamma: float = 2.0) -> torch.Tensor:
    """Full LAB-roundtrip gamma correction of a (..., 3) u8 frame."""
    lab = rgb_to_lab_u8(frame)
    lab = torch.cat([gamma_l_channel(lab[..., :1], gamma), lab[..., 1:]], dim=-1)
    return lab_to_rgb_u8(lab)


def bgr_to_gray_u8(frame: torch.Tensor) -> torch.Tensor:
    """COLOR_BGR2GRAY on u8 (..., 3) stored B, G, R -> u8, cv2 fixed point."""
    f = frame.to(torch.int32)
    y = (4899 * f[..., 2] + 9617 * f[..., 1] + 1868 * f[..., 0] + (1 << 13)) >> 14
    return torch.clamp(y, 0, 255).to(torch.uint8)
