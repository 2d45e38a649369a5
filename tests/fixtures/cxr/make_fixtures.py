"""Writes the synthetic chest-X-ray-like JPEGs of this directory: 8 smooth
8-bit grays of about 600 x 700 pixels (a bright body, two darker lung
fields, a spine, ribs, a heart shadow and faint grain), from a fixed seed.
They feed the stage-1 loader tests and chip_smoke.py's stage1 phase.

  python tests/fixtures/cxr/make_fixtures.py      # needs numpy and Pillow
"""
from pathlib import Path

import numpy as np
from PIL import Image

SIZES = [(600, 700), (640, 560), (700, 600), (560, 640), (620, 680), (680, 620), (600, 600),
         (720, 580)]


def chest(h: int, w: int, rng: np.random.Generator) -> np.ndarray:
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    yn, xn = y / h - 0.5, x / w - 0.5
    img = 60 + 120 * np.exp(-((xn / 0.42) ** 6 + (yn / 0.48) ** 6))          # the body
    for side in (-1, 1):                                                     # lung fields
        cx = side * (0.17 + 0.02 * rng.standard_normal())
        img -= 70 * np.exp(-(((xn - cx) / 0.13) ** 2 + ((yn + 0.02) / 0.28) ** 2) ** 2)
    img += 50 * np.exp(-(xn / 0.035) ** 2) * (yn > -0.45)                    # the spine
    img += 8 * np.sin(2 * np.pi * (yn * 9 + 0.6 * np.abs(xn)) + rng.uniform(0, 6)) \
        * np.exp(-(xn / 0.3) ** 2)                                           # ribs
    img += 35 * np.exp(-(((xn + 0.05) / 0.12) ** 2 + ((yn - 0.15) / 0.12) ** 2))  # heart
    img += 2 * rng.standard_normal((h, w))                                   # grain
    return np.clip(img, 0, 255).astype(np.uint8)


def main() -> None:
    out = Path(__file__).resolve().parent
    rng = np.random.default_rng(2026)
    for i, (h, w) in enumerate(SIZES):
        Image.fromarray(chest(h, w, rng), "L").save(out / f"cxr_{i}.jpg", quality=85)


if __name__ == "__main__":
    main()
