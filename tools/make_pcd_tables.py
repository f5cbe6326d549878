"""Recover the PhotoYCC -> RGB tables that Pillow's PCD decoder uses
(libImaging's YCC unpacker, compiled into Pillow, not installed as source)
from Pillow's own output, and print them as the C arrays of
tracy_tpu_torch/csrc/image_legacy.cpp.

The unpacker computes, per pixel of luma Y and chroma C1 (Cb), C2 (Cr),
    r = clip(L[Y] + CR[C2]),  g = clip(L[Y] + GR[C2] + GB[C1]),
    b = clip(L[Y] + CB[C1]),  clip(v) = min(max(v, 0), 255),
so every unclipped output is one linear equation between two or three
table entries. The script decodes Photo CD files of seeded random (Y, C1,
C2) with PIL, solves the equations by walking them from L[0] = 0 and
GR[137] = 0 (the tables are fixed only up to those two constants, which
cancel in every sum), and checks the tables against a second seeded file.

    python tools/make_pcd_tables.py > tables.txt   (needs Pillow, about 10 s)
"""

import io

import numpy as np
from PIL import Image

W, H = 768, 512


def pcd_file(y, c1, c2, orientation=0):
    """A Photo CD file of luma y [512, 768] and chroma c1, c2 [256, 384]
    (one chroma sample for each 2x2 pixels), as PIL's decoder reads it: the
    base image at 96 x 2048, each pair of rows as Y, Y, C1, C2."""
    data = bytearray(96 * 2048)
    data[2048:2052] = b"PCD_"
    data[2048 + 1538] = orientation
    rows = np.concatenate([y.reshape(256, 2 * W), c1, c2], axis=1)
    return bytes(data) + rows.astype(np.uint8).tobytes()


def pil_rgb(y, c1, c2):
    return np.asarray(Image.open(io.BytesIO(pcd_file(y, c1, c2))).convert("RGB")).astype(int)


def sample(seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 256, (H, W))
    c1, c2 = rng.integers(0, 256, (2, H // 2, W // 2))
    up = lambda c: np.repeat(np.repeat(c, 2, axis=0), 2, axis=1)  # noqa: E731
    return y, c1, c2, up(c1), up(c2)


def solve(pairs, fixed):
    """Values of a[i] + b[j] = v (pairs: (i, j, v) arrays), a[fixed] = 0;
    None where no unclipped equation reaches an entry."""
    a, b = [None] * 256, [None] * 256
    a[fixed] = 0
    i, j, v = pairs
    changed = True
    while changed:
        changed = False
        for ii, jj, vv in zip(i, j, v):
            if a[ii] is not None and b[jj] is None:
                b[jj], changed = vv - a[ii], True
            elif b[jj] is not None and a[ii] is None:
                a[ii], changed = vv - b[jj], True
    return a, b


def unique(*cols):
    return np.unique(np.stack(cols, 1), axis=0).T


def main():
    y, c1, c2, u1, u2 = sample(1)
    rgb = pil_rgb(y, c1, c2)
    ok = (rgb > 0) & (rgb < 255)
    r, g, b = (rgb[..., k] for k in range(3))
    L, CR = solve(unique(y[ok[..., 0]], u2[ok[..., 0]], r[ok[..., 0]]), 0)
    CB = [None] * 256
    for yy, cc, vv in zip(*unique(y[ok[..., 2]], u1[ok[..., 2]], b[ok[..., 2]])):
        CB[cc] = vv - L[yy]
    Lg = np.array(L)
    GR, GB = solve(unique(u2[ok[..., 1]], u1[ok[..., 1]], g[ok[..., 1]] - Lg[y[ok[..., 1]]]),
                   137)
    tables = {"L": L, "CB": CB, "GB": GB, "CR": CR, "GR": GR}
    assert all(v is not None for t in tables.values() for v in t), "an entry was never seen"

    # Check on a second file: every output, clipped or not.
    y, c1, c2, u1, u2 = sample(2)
    t = {k: np.array(v) for k, v in tables.items()}
    want = np.stack([t["L"][y] + t["CR"][u2], t["L"][y] + t["GR"][u2] + t["GB"][u1],
                     t["L"][y] + t["CB"][u1]], -1).clip(0, 255)
    assert (want == pil_rgb(y, c1, c2)).all()
    for name, vals in tables.items():
        body = ",".join(f"{'\n    ' if k % 16 == 0 else ' '}{v}" for k, v in enumerate(vals))
        print(f"const int16_t kYcc{name}[256] = {{{body}}};")


if __name__ == "__main__":
    main()
