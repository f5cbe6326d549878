"""Vector math on batched `[..., 3]` tensors plus host-side matrix builders.

Port of tracy_tpu/core/math.py. Dot products are written as explicit
component sums so that the order of operations is the same on every device
(a reduction kernel may sum in another order).
"""

from __future__ import annotations

import numpy as np
import torch

PI = 3.1415926535897932
# Reference EPS (common.h:157). Used by intersection tests and russian roulette.
EPS = 1.0e-8


def dot(a, b, keepdim: bool = True):
    """Dot product over the trailing axis, summed x + y + z in that order."""
    out = a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]
    return out.unsqueeze(-1) if keepdim else out


def cross(a, b):
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def length(v, keepdim: bool = True):
    """|v| over the trailing axis: dot(v, v)'s root through `sqrt`."""
    return sqrt(dot(v, v, keepdim))


def sqrt(x):
    """The correctly rounded square root, on every device, as XLA's and the
    card's (IEEE) sqrt are. On the CPU torch's float32 sqrt goes through
    MKL's vector math library: 1 ulp off on about 0.6% of inputs, and seen
    to return a thread's whole chunk 2.5e-5 to 1.2e-4 off now and then
    (ROADMAP, hazards). There two Newton steps in float64, exact IEEE
    operations, take any such result to the exact root before it is
    rounded back to float32 (no float32 root lies within their error of a
    rounding boundary).

    Under autograd the CPU route's gradient is the Newton steps', with
    their seed detached: 0.5 / sqrt(x) to float32 rounding. Where the root
    is 0 (x = 0, as a clamp in front gives), not finite or NaN, the
    gradient is 0, not torch.sqrt's 0 * inf = NaN: those lanes run the
    steps on 1.0, and their value, torch's, is detached."""
    s = torch.sqrt(x)
    if x.device.type != "cpu" or x.dtype != torch.float32:
        return s
    ok = (s > 0.0) & torch.isfinite(s)
    one = torch.ones((), dtype=x.dtype)
    xd = torch.where(ok, x, one).double()
    r = torch.where(ok, s, one).detach().double()
    r = 0.5 * (r + xd / r)
    r = 0.5 * (r + xd / r)
    return torch.where(ok, r.float(), s.detach())


def fma(a, b, c):
    """a * b + c on float32 tensors, rounded once, as the card's fmaf
    (`__fmaf_rn`) rounds it, on every device: the product is exact in
    float64, TwoSum gives the sum's exact error, and a sum that is not
    exact is rounded to odd (stepped one ulp toward the error where its
    last bit is even) before the cast to float32, so that the two
    roundings give the one correctly rounded result. Separate tensor ops
    (no addcmul), so that no device contracts them again."""
    a, b, c = a.double(), b.double(), c.double()
    p = a * b
    s = p + c
    pv = s - c
    err = (p - pv) + (c - (s - pv))
    even = (s.view(torch.int64) & 1) == 0
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=s.device)
    toward = torch.where(err > 0, inf, -inf)
    s = torch.where(even & (err != 0) & torch.isfinite(err), torch.nextafter(s, toward), s)
    return s.float()


def gather_rows(table, idx):
    """table[idx] along the first axis, through
    torch.nn.functional.embedding: the values of indexing, but under
    autograd the backward sums each row's gradients by sorted segments.
    Indexing's backward (index_put_ with accumulate) adds a row's
    duplicates one after another on CUDA, and a table of a few rows read
    by every lane (the material table, or texel 0 where a lane reads
    none) took 245 ms of a 290 ms training step on the H100
    (chip_smoke.py's profile, PERF.md)."""
    if table.dim() == 1:
        return torch.nn.functional.embedding(idx, table[:, None])[..., 0]
    return torch.nn.functional.embedding(idx, table)


def normalize(v, eps: float = 1.0e-20):
    """v / |v| with the squared length clamped at `eps` (no 0/0 -> NaN)."""
    return v / sqrt(torch.clamp(dot(v, v), min=eps))


def lerp(a, b, t):
    """a + (b - a) * t (GLM lerp argument order)."""
    return a + (b - a) * t


def reflect(incident, normal):
    """GLM reflect: I - 2*dot(N, I)*N (reference material.h:232)."""
    return incident - 2.0 * dot(normal, incident) * normal


def refract(incident, normal, eta):
    """GLM refract; the zero vector on total internal reflection."""
    cosi = dot(normal, incident)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    refr = eta * incident - (eta * cosi + sqrt(torch.clamp(k, min=0.0))) * normal
    return torch.where(k < 0.0, torch.zeros_like(refr), refr)


def srgb_from_linear(x):
    """Linear -> sRGB, standard piecewise curve."""
    x = torch.clamp(x, min=0.0)
    lo = x * 12.92
    hi = 1.055 * torch.pow(torch.clamp(x, min=1e-8), 1.0 / 2.4) - 0.055
    return torch.where(x <= 0.0031308, lo, hi)


def linear_from_srgb(x):
    """sRGB -> linear, standard piecewise curve (GLM convertSRGBToLinear)."""
    x = torch.clamp(x, min=0.0)
    lo = x / 12.92
    hi = torch.pow((x + 0.055) / 1.055, 2.4)
    return torch.where(x <= 0.04045, lo, hi)


def reinhard(x):
    return x / (1.0 + x)


def aces(x):
    """ACES filmic fit (Narkowicz 2015)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


# Rec. 709 luma weights (tracy_tpu's luminance).
LUMA = (0.2126, 0.7152, 0.0722)


def luminance(rgb):
    """Rec. 709 luminance over the trailing axis, r, g and b weighted and
    summed in that order."""
    w = torch.tensor(LUMA, dtype=rgb.dtype, device=rgb.device)
    return rgb[..., 0] * w[0] + rgb[..., 1] * w[1] + rgb[..., 2] * w[2]


# ---------------------------------------------------------------------------
# Host-side (numpy, float64) matrix builders, identical to the JAX package's.
# ---------------------------------------------------------------------------


def look_at(eye, center, up) -> np.ndarray:
    """Right-handed view matrix (GLM lookAtRH)."""
    eye = np.asarray(eye, dtype=np.float64)
    center = np.asarray(center, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)

    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)

    m = np.eye(4, dtype=np.float64)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def perspective(fovy_radians: float, aspect: float, znear: float, zfar: float) -> np.ndarray:
    """Right-handed GL projection, clip z in [-1, 1] (GLM perspectiveRH_NO)."""
    f = 1.0 / np.tan(fovy_radians / 2.0)
    m = np.zeros((4, 4), dtype=np.float64)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (zfar + znear) / (znear - zfar)
    m[2, 3] = (2.0 * zfar * znear) / (znear - zfar)
    m[3, 2] = -1.0
    return m


def translate(t) -> np.ndarray:
    m = np.eye(4, dtype=np.float64)
    m[:3, 3] = np.asarray(t, dtype=np.float64)
    return m


def scale(s) -> np.ndarray:
    s = np.asarray(s, dtype=np.float64)
    if s.ndim == 0:
        s = np.full((3,), float(s))
    m = np.eye(4, dtype=np.float64)
    m[0, 0], m[1, 1], m[2, 2] = s
    return m


def rotate_axis(angle_radians: float, axis) -> np.ndarray:
    """Rotation about an arbitrary axis (GLM rotate)."""
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    x, y, z = axis
    c, s = np.cos(angle_radians), np.sin(angle_radians)
    C = 1.0 - c
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = np.array(
        [
            [c + x * x * C, x * y * C - z * s, x * z * C + y * s],
            [y * x * C + z * s, c + y * y * C, y * z * C - x * s],
            [z * x * C - y * s, z * y * C + x * s, c + z * z * C],
        ]
    )
    return m


def radians(deg: float) -> float:
    return float(deg) * np.pi / 180.0
