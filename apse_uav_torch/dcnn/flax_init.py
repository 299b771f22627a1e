"""The reference's default parameter initialisation, reproduced in numpy.

The JAX reference initialises a module it has no checkpoint for with
``module.init(jax.random.PRNGKey(seed), ...)``: flax folds the parameter's
path into the key, and ``lecun_normal`` draws a truncated normal from the
Threefry-2x32 counter generator.  This module computes the same numbers
without JAX, so a tracker that runs without trained re-ID weights assigns
the ids the reference assigns:

* keys: ``PRNGKey(seed)`` is ``[seed >> 32, seed & 0xffffffff]``;
  ``fold_in(key, d)`` hashes the counter pair ``(0, d)``;
* flax's static fold-in: SHA-1 of the scope path and the rng counter (no
  separators, flax's default), its first 4 bytes big-endian;
* random bits (``jax_threefry_partitionable``, on by default): Threefry-2x32
  of the 64-bit iota over the flattened shape, the two output words XORed;
* ``uniform``: 23 random mantissa bits over [1, 2), minus 1, scaled to
  [minval, maxval);
* ``truncated_normal``: ``sqrt(2) * erfinv(u)`` for u uniform in
  ``[erf(lower / sqrt 2), erf(upper / sqrt 2))``, clamped inside the bounds;
  ``erfinv`` is Giles' single-precision polynomial, the one XLA uses;
* products followed by a sum round once, as XLA's CPU code fuses them;
* ``lecun_normal``: that normal at (-2, 2), times
  ``sqrt(1 / fan_in) / 0.87962566103423978``, fan_in = kh * kw * cin for a
  convolution kernel;
* ``normal(stddev)``: ``sqrt(2) * erfinv(u)`` for u uniform in
  [nextafter(-1, 0), 1), times stddev;
* ``split(key, n)``: key i is the block function of the counter (0, i)
  (the partitionable layout, the same as ``fold_in(key, i)``).

Every step runs in float32 as the reference does; the one difference is in
``erfinv``'s and ``log1p``'s last bits (``tests/test_torch_checkpoint.py``
states the largest).

The functions ending in ``_t`` compute the same numbers with torch on any
device, in int64 arithmetic masked to 32 bits: the training losses draw
their sampling priorities with them on the card (hundreds of thousands a
step), and :func:`mask_rcnn_init` draws a whole model's initialisation.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _fma(a, b, c) -> np.ndarray:
    """float32 a * b + c rounded once, as XLA's CPU code contracts it (the
    float64 product of two float32 values is exact)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(np.float32)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 block function (20 rounds) of ``key`` (2,) uint32 on
    the counter words x0, x1 (uint32 arrays of one shape)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [x0.astype(np.uint32) + ks[0], x1.astype(np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` (threefry) as (2,) uint32."""
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``."""
    o0, o1 = threefry2x32(key, np.zeros(1, np.uint32), np.array([data & 0xFFFFFFFF], np.uint32))
    return np.array([o0[0], o1[0]], np.uint32)


def fold_in_path(key: np.ndarray, path: tuple) -> np.ndarray:
    """flax's ``LazyRng`` fold-in of static data (scope names and rng counters)."""
    if not path:
        return key
    m = hashlib.sha1()
    for x in path:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(int(x).to_bytes((int(x).bit_length() + 7) // 8, byteorder="big"))
    return fold_in(key, int.from_bytes(m.digest()[:4], byteorder="big"))


def random_bits32(key: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """32 random bits per element (the partitionable Threefry layout)."""
    n = math.prod(shape)
    lo = np.arange(n, dtype=np.uint64)
    b0, b1 = threefry2x32(key, (lo >> np.uint64(32)).astype(np.uint32), lo.astype(np.uint32))
    return (b0 ^ b1).reshape(shape)


def split(key: np.ndarray, n: int = 2) -> np.ndarray:
    """``jax.random.split(key, n)`` as (n, 2) uint32."""
    o0, o1 = threefry2x32(key, np.zeros(n, np.uint32), np.arange(n, dtype=np.uint32))
    return np.stack([o0, o1], axis=1)


def uniform(key: np.ndarray, shape: tuple[int, ...], minval, maxval) -> np.ndarray:
    """``jax.random.uniform`` in float32."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = (random_bits32(key, shape) >> np.uint32(9)) | np.float32(1.0).view(np.uint32)
    floats = bits.view(np.float32) - np.float32(1.0)
    return np.maximum(lo, _fma(floats, hi - lo, lo))


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv32(x: np.ndarray) -> np.ndarray:
    """Giles' single-precision inverse error function, in float32."""
    x = np.asarray(x, np.float32)
    w = -np.log1p((-x * x).astype(np.float64)).astype(np.float32)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    p = np.where(lt, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0])).astype(np.float32)
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, np.where(lt, np.float32(a), np.float32(b)))
    out = p * x
    return np.where(np.abs(x) == 1, x * np.finfo(np.float32).max, out).astype(np.float32)


def truncated_normal(key: np.ndarray, lower: float, upper: float, shape: tuple[int, ...]) -> np.ndarray:
    """``jax.random.truncated_normal`` in float32."""
    sqrt2 = np.float32(np.sqrt(2))
    lo, hi = np.float32(lower), np.float32(upper)
    a = np.float32(math.erf(float(lo / sqrt2)))
    b = np.float32(math.erf(float(hi / sqrt2)))
    out = sqrt2 * erfinv32(uniform(key, shape, a, b))
    return np.clip(out, np.nextafter(lo, np.float32(np.inf)), np.nextafter(hi, np.float32(-np.inf)))


def lecun_normal(key: np.ndarray, shape: tuple[int, int]) -> np.ndarray:
    """flax's default Dense kernel init for a (fan_in, fan_out) kernel."""
    variance = np.float32(1.0 / shape[0])
    stddev = np.sqrt(variance) / np.float32(0.87962566103423978)
    return (truncated_normal(key, -2.0, 2.0, shape) * stddev).astype(np.float32)


def normal(key: np.ndarray, shape: tuple[int, ...], stddev: float = 1.0) -> np.ndarray:
    """``jax.random.normal`` (times ``stddev``, flax's ``initializers.normal``) in float32."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    out = np.float32(np.sqrt(2)) * erfinv32(uniform(key, shape, lo, 1.0))
    return (out * np.float32(stddev)).astype(np.float32)


def dense_init(seed: int, path: tuple[str, ...], in_dim: int, out_dim: int) -> tuple[np.ndarray, np.ndarray]:
    """(kernel (in_dim, out_dim), bias (out_dim,)) of a flax ``nn.Dense`` at the
    scope ``path`` of a module initialised with ``PRNGKey(seed)``: the kernel
    takes the scope's first ``params`` draw, the bias is zero."""
    key = fold_in_path(prng_key(seed), (*path, 1))
    return lecun_normal(key, (in_dim, out_dim)), np.zeros(out_dim, np.float32)


# -- the same streams on a torch device --------------------------------------

_M32 = 0xFFFFFFFF


def _rotl_t(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _M32


def threefry2x32_t(keys: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`threefry2x32` of each key of ``keys`` (K, 2) on the counter
    words x0, x1 (N,), in int64 holding 32-bit values -> two (K, N) words."""
    k0, k1 = keys[:, :1], keys[:, 1:]
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    a, b = (x0 + k0) & _M32, (x1 + k1) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _M32
            b = _rotl_t(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _M32
    return a, b


def random_bits32_t(keys: np.ndarray, n: int, device) -> torch.Tensor:
    """:func:`random_bits32` of each key of ``keys`` (K, 2) uint32 over n
    elements, on ``device``: (K, n) int64 holding the 32-bit words."""
    k = torch.as_tensor(np.asarray(keys, np.int64).reshape(-1, 2), device=device)
    lo = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32_t(k, lo >> 32, lo & _M32)
    return b0 ^ b1


def _fma_t(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a * b + c rounded once (see :func:`_fma`)."""
    b = b.double() if torch.is_tensor(b) else float(b)
    c = c.double() if torch.is_tensor(c) else float(c)
    return (a.double() * b + c).float()


def uniform_t(keys: np.ndarray, n: int, device, minval=0.0, maxval=1.0) -> torch.Tensor:
    """:func:`uniform` of each key of ``keys`` (K, 2) over n elements: (K, n) float32 on ``device``."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = (random_bits32_t(keys, n, device) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp(_fma_t(floats, hi - lo, lo), min=float(lo))


def erfinv32_t(x: torch.Tensor) -> torch.Tensor:
    """:func:`erfinv32` in torch."""
    w = (-torch.log1p((-x * x).double())).float()
    lt = w < 5.0
    # The square root in float64, rounded once to float32 (torch's float32
    # sqrt on the CPU is not always correctly rounded).
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).float()
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma_t(p, w, torch.where(lt, np.float32(a).item(), np.float32(b).item()).float())
    out = p * x
    return torch.where(x.abs() == 1, x * float(np.finfo(np.float32).max), out)


def normal_t(key: np.ndarray, n: int, device, stddev: float = 1.0) -> torch.Tensor:
    """flax's ``initializers.normal(stddev)`` of one key over n elements as
    XLA computes it inside ``jax.jit`` (the reference's ``model.init``): the
    two constants folded into one factor, ``erfinv(u) * float32(sqrt(2) *
    stddev)``.  (n,) float32 on ``device``."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform_t(np.asarray(key)[None], n, device, lo, 1.0)[0]
    return erfinv32_t(u) * float(np.float32(np.sqrt(2)) * np.float32(stddev))


def truncated_normal_t(key: np.ndarray, lower: float, upper: float, n: int, device) -> torch.Tensor:
    """:func:`truncated_normal` of one key over n elements: (n,) float32 on ``device``."""
    sqrt2 = np.float32(np.sqrt(2))
    lo, hi = np.float32(lower), np.float32(upper)
    a = np.float32(math.erf(float(lo / sqrt2)))
    b = np.float32(math.erf(float(hi / sqrt2)))
    out = float(sqrt2) * erfinv32_t(uniform_t(np.asarray(key)[None], n, device, a, b)[0])
    return out.clamp(float(np.nextafter(lo, np.float32(np.inf))), float(np.nextafter(hi, np.float32(-np.inf))))


def lecun_normal_t(key: np.ndarray, shape: tuple[int, ...], device) -> torch.Tensor:
    """flax's default kernel init of a Dense (fan_in, fan_out) or a
    convolution (kh, kw, cin, cout) kernel, in that (flax) layout."""
    fan_in = math.prod(shape[:-1])
    stddev = np.sqrt(np.float32(1.0 / fan_in)) / np.float32(0.87962566103423978)
    return (truncated_normal_t(key, -2.0, 2.0, math.prod(shape), device) * float(stddev)).reshape(shape)


def _flax_params(cfg) -> list[tuple[str, tuple[int, ...], str]]:
    """The JAX MaskRCNN's (or, for a C4 config, MaskRCNNC4's) parameters of
    ``cfg`` in the order of their scopes: ('/'-joined flax path, shape in
    flax layout, initialiser), the initialiser ``lecun``, ``normal:<stddev>``,
    ``zeros`` or ``ones``.  A ResNeXt config (which the JAX package lacks)
    gets grouped conv2 kernels, (3, 3, width / groups, width), drawn as flax
    draws a convolution with ``feature_group_count``.  A ViTDet config raises:
    the JAX package has no ViT whose initialisation to reproduce."""
    from apse_uav_torch.dcnn.models.resnet import STAGE_BLOCKS

    if cfg.architecture == "vitdet":
        raise ValueError("architecture='vitdet': the JAX package has no ViTDet, so there is no flax "
                         "initialisation to draw; load a detectron2 ViTDet checkpoint")

    out = []

    def conv(path, k, cin, cout, bias=True, init="lecun"):
        out.append((f"{path}/kernel", (k, k, cin, cout), init))
        if bias:
            out.append((f"{path}/bias", (cout,), "zeros"))

    def bn(path, ch):
        out.extend([(f"{path}/scale", (ch,), "ones"), (f"{path}/bias", (ch,), "zeros"),
                    (f"{path}/mean", (ch,), "zeros"), (f"{path}/var", (ch,), "ones")])

    def stage(prefix, s):
        out_ch, mid = 256 * 2**s, cfg.num_groups * cfg.width_per_group * 2**s
        in_ch = 64 if s == 0 else out_ch // 2
        for b in range(STAGE_BLOCKS[cfg.depth][s]):
            p = f"{prefix}/res{s + 2}_{b}"
            cin = in_ch if b == 0 else out_ch
            # A grouped 3x3 (ResNeXt) holds mid / groups inputs per output, as
            # flax's feature_group_count kernel; its LeCun fan-in is that times 9.
            convs = ((1, cin, mid), (3, mid // cfg.num_groups, mid), (1, mid, out_ch))
            for i, (k, ci, co) in enumerate(convs, start=1):
                conv(f"{p}/conv{i}", k, ci, co, bias=False)
                bn(f"{p}/bn{i}", co)
            if b == 0:
                conv(f"{p}/shortcut", 1, cin, out_ch, bias=False)
                bn(f"{p}/shortcut_bn", out_ch)

    c4 = cfg.architecture == "c4"
    rn = "backbone" if c4 else "backbone/resnet"
    conv(f"{rn}/stem_conv", 7, 3, 64, bias=False)
    bn(f"{rn}/stem_bn", 64)
    for s in range(3 if c4 else 4):
        stage(rn, s)
    roi = cfg.roi
    if c4:  # MaskRCNNC4: rpn_head on res4, res5 in the head, C4BoxPredictor, MaskHead(num_conv=0)
        ch, a, head_in = 1024, cfg.anchors.num_cell_anchors, 2048
        stage("res5", 3)
        pred = "box_predictor"
    else:
        ch, a = cfg.fpn_channels, len(cfg.anchors.aspect_ratios)
        for i, c in enumerate((256, 512, 1024, 2048)):
            conv(f"backbone/fpn/lateral{i + 2}", 1, c, ch)
            conv(f"backbone/fpn/output{i + 2}", 3, ch, ch)
        pred = "box_head"
        head_in = roi.box_fc_dim
    conv("rpn_head/conv", 3, ch, ch, init="normal:0.01")
    conv("rpn_head/objectness", 1, ch, a, init="normal:0.01")
    conv("rpn_head/deltas", 1, ch, 4 * a, init="normal:0.01")
    if not c4:
        dims = [ch * roi.box_pooler_resolution**2] + [roi.box_fc_dim] * roi.num_box_fc
        for i in range(roi.num_box_fc):
            out += [(f"box_head/fc{i + 1}/kernel", (dims[i], dims[i + 1]), "lecun"),
                    (f"box_head/fc{i + 1}/bias", (dims[i + 1],), "zeros")]
    out += [(f"{pred}/cls_score/kernel", (head_in, roi.num_classes + 1), "normal:0.01"),
            (f"{pred}/cls_score/bias", (roi.num_classes + 1,), "zeros"),
            (f"{pred}/bbox_pred/kernel", (head_in, 4 * roi.num_classes), "normal:0.001"),
            (f"{pred}/bbox_pred/bias", (4 * roi.num_classes,), "zeros")]
    if cfg.mask_on:
        num_conv = 0 if c4 else roi.num_mask_conv
        for i in range(num_conv):
            conv(f"mask_head/mask_fcn{i + 1}", 3, ch if i == 0 else roi.mask_conv_dim, roi.mask_conv_dim)
        conv("mask_head/deconv", 2, roi.mask_conv_dim if num_conv else (2048 if c4 else ch), roi.mask_conv_dim)
        conv("mask_head/predictor", 1, roi.mask_conv_dim, roi.num_classes, init="normal:0.001")
    return out


def mask_rcnn_init(cfg, seed: int = 0, device="cpu", only=None) -> dict[str, np.ndarray]:
    """The JAX MaskRCNN (MaskRCNNC4 for a C4 config) of ``cfg`` initialised with ``PRNGKey(seed)``
    (``model.init`` under ``jax.jit``, as the reference's loop and CLIs
    call it), as the port's state dict of float32 numpy arrays
    (detectron2 names, through ``convert.mask_rcnn_state_dict``), drawn on
    ``device``.  Each
    parameter takes its scope's draw: the kernel the first, the bias the
    second (frozen BN: scale, bias, mean, var the first to the fourth).
    ``only``: the state-dict names to compute (the others are left out)."""
    from apse_uav_torch import convert

    root = prng_key(seed)
    counters: dict[str, int] = {}
    flat = {}
    for path, shape, init in _flax_params(cfg):
        scope = path.rsplit("/", 1)[0]
        counters[scope] = counters.get(scope, 0) + 1
        if only is not None and convert._mask_rcnn_key(path)[0] not in only:
            continue
        if init == "zeros":
            flat[path] = torch.zeros(shape, device=device)
        elif init == "ones":
            flat[path] = torch.ones(shape, device=device)
        else:
            key = fold_in_path(root, (*scope.split("/"), counters[scope]))
            if init == "lecun":
                flat[path] = lecun_normal_t(key, shape, device)
            else:
                flat[path] = normal_t(key, math.prod(shape), device, float(init.split(":")[1])).reshape(shape)
    return convert.mask_rcnn_state_dict({k: v.cpu().numpy() for k, v in flat.items()})
