"""Decode data/labrador.jpg once into sde_sampler_torch/data/labrador_rgb.npz.

The image target of the PyTorch port (`sde_sampler_torch/distr/img.py`)
reads the decoded pixels from this file, so that it needs no image library
(matplotlib, PIL) where it runs. The array is matplotlib's decode of the
JPEG, `matplotlib.image.imread`, exactly as the JAX package's `Img` reads
it: (720, 1280, 3) uint8, stored compressed under the key "rgb".

    python scripts/decode_labrador.py            # writes the .npz
    python scripts/decode_labrador.py --check    # fails if the file differs

tests/test_torch_port_img.py::test_decoded_image_file_equals_matplotlib_decode
holds the committed file equal to the decode.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
JPEG = REPO / "data" / "labrador.jpg"
NPZ = REPO / "sde_sampler_torch" / "data" / "labrador_rgb.npz"


def decode(path: Path = JPEG) -> np.ndarray:
    import matplotlib.image as mpimg

    rgb = mpimg.imread(path)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected an 8-bit RGB image, got {rgb.dtype} {rgb.shape}")
    return rgb


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--check", action="store_true",
                        help="compare the committed file with a fresh decode")
    args = parser.parse_args()
    rgb = decode()
    if args.check:
        same = np.array_equal(np.load(NPZ)["rgb"], rgb)
        print(f"{NPZ.name}: {'equal to' if same else 'DIFFERS from'} the decode of {JPEG.name}")
        return 0 if same else 1
    np.savez_compressed(NPZ, rgb=rgb)
    print(f"wrote {NPZ} ({NPZ.stat().st_size} bytes), {rgb.shape} {rgb.dtype}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
